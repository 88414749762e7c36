"""The port's SSM and hybrid training slice (``kernels.ssd``'s
``ssd_scan_bwd_plain``, the ``ssd_scan`` autograd Function and its CUDA
branch's arguments, the ssm and hybrid families through
``transformer.loss_fn`` with and without remat, ``train.make_train_step``
and ``launch.train``) against the JAX package's, on the CPU at small size.
Inputs come from numpy seeds; the reference makes the params
(``jax.random``) and ``transformer.from_reference`` carries them over.

The reference's gradient of its chunked scan (``jax.grad`` of
``ssm.ssd_chunked``) is NaN wherever exp(cum_i − cum_j) overflows above a
chunk's diagonal: ``jnp.where(tri, exp(diff), 0)`` differentiates the
dropped inf as 0·inf. The reduced mamba2 and zamba2 reach that at their
own weights (A down to −16 over 32-token chunks), so the model-level
references here run the reference's ``loss_fn`` with its SSD core taken
by its recurrent oracle (``ref.ssd_naive_ref``, the same function with
no exp of a positive argument), and the large-dt case of the plain
backward is held to ``jax.vjp`` of that oracle.

Tolerances:
* ``ssd_scan_bwd_plain`` against ``jax.vjp`` of ``ssd_chunked`` (or of
  ``ssd_naive_ref``) and against torch autograd through
  ``ssd_scan_plain``: 1e-5 of each output's max|ref| (the same f32
  arithmetic in another order);
* ``loss_fn``: 1e-5 relative; every gradient leaf, and the f32 moments
  and metrics after train steps: 1e-4 of the leaf's max|ref|, the
  convention of ``test_torch_train.py``; the params after train steps the
  same wherever AdamW's step is well conditioned, and within the steps'
  summed lr elsewhere (``_step_param_rels``: the SSD core's recurrent
  oracle rounds a gradient element of |g| ~ eps otherwise than the
  chunked scan, and m̂/(√v̂ + eps) turns that into a step of up to lr);
* remat against no remat, and the autograd Function against the plain
  backward it calls: bitwise.
"""
import contextlib
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch import optim as PA  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import _native, ops  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
# the reduced depths: mamba2 at 2 layers, zamba2 at 4 (two groups of 2,
# so the shared block's gradient sums two applications)
DEPTH = {"mamba2-2.7b": 2, "zamba2-2.7b": 4}
GRADS = ("dx", "ddt", "dA", "dBm", "dCm", "dD", "d init")


def _rng(*key):
    return np.random.default_rng(list(key))


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# ssd_scan_bwd_plain
# ---------------------------------------------------------------------------
def _inputs(B, nc, Q, H, P, N, seed, dt_scale=0.3):
    """(x, dt, A, Bm, Cm, D, init, dy, d final) as f32 numpy arrays."""
    rng = _rng(B, nc, Q, H, P, N, seed)
    S = nc * Q

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    dt = (np.abs(rng.standard_normal((B, S, H))) * dt_scale).astype(
        np.float32)
    A = -np.linspace(0.5, 2.0, H).astype(np.float32)
    return (normal(B, S, H, P, scale=0.5), dt, A, normal(B, S, N, scale=0.5),
            normal(B, S, N, scale=0.5), normal(H), normal(B, H, P, N,
                                                          scale=0.3),
            normal(B, S, H, P), normal(B, H, P, N))


def _plain_bwd(x, dt, A, Bm, Cm, D, init, dy, dfinal, Q):
    """``ssd_scan_bwd_plain`` on the plain forward's buffers."""
    t = [torch.from_numpy(a) if a is not None else None
         for a in (x, dt, A, Bm, Cm, D, init, dy, dfinal)]
    _, _, (cum, CB, ins) = SSD._ssd_forward(*t[:6], Q, t[6], True)
    return SSD.ssd_scan_bwd_plain(*t[:6], cum, CB, ins, t[7], t[8])


def _autograd(x, dt, A, Bm, Cm, D, init, dy, dfinal, Q):
    """Torch autograd through ``ssd_scan_plain``: the same seven
    gradients (d init None without an initial state)."""
    ins = [torch.from_numpy(a).requires_grad_()
           for a in (x, dt, A, Bm, Cm, D)]
    st = None if init is None else torch.from_numpy(init).requires_grad_()
    y, fin = SSD.ssd_scan_plain(*ins, chunk=Q, init_state=st)
    loss = (y * torch.from_numpy(dy)).sum()
    if dfinal is not None:
        loss = loss + (fin * torch.from_numpy(dfinal)).sum()
    g = torch.autograd.grad(loss, ins + ([] if st is None else [st]))
    return list(g) + ([None] if st is None else [])


def _vjp(fn, primals, dy, dfinal):
    """``jax.vjp`` of ``fn`` (returning (y, final)) at ``primals`` under
    (dy, d final or zero)."""
    (y, fin), vjp = jax.vjp(fn, *map(jnp.asarray, primals))
    return vjp((jnp.asarray(dy), jnp.zeros_like(fin) if dfinal is None
                else jnp.asarray(dfinal)))


# (B, nc, Q, H, P, N, initial state, nonzero d final)
BWD_CASES = [(2, 1, 32, 3, 8, 5, False, False),
             (2, 3, 32, 3, 8, 5, True, True),
             (1, 3, 16, 4, 16, 8, False, True),
             (2, 1, 48, 2, 12, 6, True, False)]


@pytest.mark.parametrize("case", BWD_CASES, ids=lambda c: "-".join(
    f"{v}" for v in c))
def test_ssd_scan_bwd_plain_matches_jax_vjp_and_autograd(case):
    """The seven gradients of ``ssd_scan_bwd_plain`` (its explicit
    formulas, no autograd) against ``jax.vjp`` of the reference's
    ``ssd_chunked`` and against torch autograd through ``ssd_scan_plain``,
    with and without an initial state, a zero and a nonzero d final, 1 and
    3 chunks: 1e-5 of max|ref| each; dx, dBm, dCm in the inputs' dtype."""
    B, nc, Q, H, P, N, init, dfin = case
    x, dt, A, Bm, Cm, D, st, dy, df = _inputs(B, nc, Q, H, P, N, 0)
    df = df if dfin else None
    got = _plain_bwd(x, dt, A, Bm, Cm, D, st if init else None, dy, df, Q)
    assert [g.dtype for g in got] == [torch.float32] * 7
    assert got[-1].shape == (B, H, P, N)

    def fn(x, dt, A, Bm, Cm, D, init_state):
        return RS.ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None], D,
                              chunk=Q, init_state=init_state)

    # no initial state is a zero one: the references take it so, and d init
    # (dy reaching the state entering the first chunk) is held either way
    st = st if init else np.zeros_like(st)
    want = _vjp(fn, (x, dt, A, Bm, Cm, D, st), dy, df)
    auto = _autograd(x, dt, A, Bm, Cm, D, st, dy, df, Q)
    for name, g, w, a in zip(GRADS, got, want, auto):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))
        assert _rel(g, a) <= 1e-5, (name, _rel(g, a))


def test_ssd_scan_bwd_plain_large_dt():
    """dt large enough that exp(cum_i − cum_j) overflows above every
    chunk's diagonal (|cum| reaches ~185 in a 32-token chunk): the plain
    backward stays finite and agrees with ``jax.vjp`` of the recurrent
    oracle ``ssd_naive_ref`` and with torch autograd through
    ``ssd_scan_plain`` (whose exponent is masked before exp) to 1e-5; a
    sign slip in one of dcum's three exps would show here."""
    B, nc, Q, H, P, N = 2, 3, 32, 3, 8, 5
    x, dt, A, Bm, Cm, D, _, dy, df = _inputs(B, nc, Q, H, P, N, 1,
                                             dt_scale=3.0)
    cum = np.cumsum((dt * A).reshape(B, nc, Q, H), axis=2)
    assert (cum[:, :, 0] - cum[:, :, -1]).max() > 88.0   # exp would overflow
    got = _plain_bwd(x, dt, A, Bm, Cm, D, None, dy, df, Q)
    assert all(bool(torch.isfinite(g).all()) for g in got)

    def fn(x, dt, A, Bm, Cm, D):
        return R.ssd_naive_ref(x, dt, A, Bm[:, :, None], Cm[:, :, None], D)

    want = _vjp(fn, (x, dt, A, Bm, Cm, D), dy, df)
    auto = _autograd(x, dt, A, Bm, Cm, D, None, dy, df, Q)
    for name, g, w, a in zip(GRADS, got, want, auto):
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))
        assert _rel(g, a) <= 1e-5, (name, _rel(g, a))


def test_ssd_scan_bwd_plain_zero_dt():
    """A zero dt (softplus never gives one) makes no NaN: ddt and dCB are
    computed from their own products, never divided by dt; the gradients
    still equal torch autograd's."""
    B, nc, Q, H, P, N = 1, 2, 16, 2, 8, 4
    x, dt, A, Bm, Cm, D, st, dy, df = _inputs(B, nc, Q, H, P, N, 2)
    dt[:, ::3] = 0.0
    got = _plain_bwd(x, dt, A, Bm, Cm, D, st, dy, df, Q)
    auto = _autograd(x, dt, A, Bm, Cm, D, st, dy, df, Q)
    for name, g, a in zip(GRADS, got, auto):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, a) <= 1e-5, (name, _rel(g, a))


def test_ssd_scan_bwd_plain_reads_only_the_lower_tiles_of_cb():
    """The kernels write C·Bᵀ on and below each chunk's diagonal only: a
    CB whose upper triangle holds NaN gives the same gradients."""
    B, nc, Q, H, P, N = 1, 2, 16, 2, 8, 4
    x, dt, A, Bm, Cm, D, st, dy, df = map(
        lambda a: torch.from_numpy(a), _inputs(B, nc, Q, H, P, N, 3))
    _, _, (cum, CB, ins) = SSD._ssd_forward(x, dt, A, Bm, Cm, D, Q, st, True)
    upper = torch.triu(torch.ones(Q, Q, dtype=torch.bool), 1)
    nan_cb = CB.masked_fill(upper, float("nan"))
    a = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, D, cum, CB, ins, dy, df)
    b = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, D, cum, nan_cb, ins, dy, df)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_ssd_scan_bwd_plain_bf16_dtypes():
    """bf16 x, Bm, Cm and dy: dx, dBm and dCm come back in bf16, each the
    f32 gradient of the same (bf16-valued) inputs rounded once; the rest
    f32."""
    B, nc, Q, H, P, N = 1, 2, 16, 2, 8, 4
    arrs = list(_inputs(B, nc, Q, H, P, N, 4))
    t = [torch.from_numpy(a) for a in arrs]
    for i in (0, 3, 4, 7):      # x, Bm, Cm, dy
        t[i] = t[i].to(torch.bfloat16)
    _, _, bufs = SSD._ssd_forward(*t[:6], Q, t[6], True)
    got = SSD.ssd_scan_bwd_plain(*t[:6], *bufs, t[7], t[8])
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32,
                                      torch.float32]
    f = [u.float() for u in t]
    _, _, fbufs = SSD._ssd_forward(*f[:6], Q, f[6], True)
    want = SSD.ssd_scan_bwd_plain(*f[:6], *fbufs, f[7], f[8])
    for name, g, w in zip(GRADS, got, want):
        same = w.to(g.dtype)
        assert torch.equal(g, same), name


def test_ssd_scan_bwd_refuses_bad_shapes():
    """``ssd_scan_bwd`` checks the forward's buffers against x: cum, CB,
    ins, dy and d final of other shapes raise ``ValueError``."""
    B, nc, Q, H, P, N = 1, 2, 16, 2, 8, 4
    t = [torch.from_numpy(a) for a in _inputs(B, nc, Q, H, P, N, 5)]
    _, _, (cum, CB, ins) = SSD._ssd_forward(*t[:6], Q, None, True)
    args = t[:6]
    for bad in ((cum[:, :1], CB, ins, t[7], None),
                (cum, CB[..., :8], ins, t[7], None),
                (cum, CB, ins[..., :4], t[7], None),
                (cum, CB, ins, t[7][:, :8], None),
                (cum, CB, ins, t[7], t[8][..., :2])):
        with pytest.raises(ValueError):
            ops.ssd_scan_bwd(*args, *bad)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_under_grad_is_the_function(init):
    """``ops.ssd_scan`` under grad returns ``_SsdScan``'s outputs (y and
    the final state have a ``grad_fn``), y equal to the plain forward's,
    and its gradients are ``ssd_scan_bwd``'s on the forward's own buffers,
    bit for bit; an unused final state costs no zero-filled gradient
    (``d final`` None); without grad nothing is recorded."""
    B, nc, Q, H, P, N = 2, 2, 16, 3, 8, 4
    x, dt, A, Bm, Cm, D, st, dy, _ = map(
        torch.from_numpy, _inputs(B, nc, Q, H, P, N, 6))
    st = st if init else None
    ins = [a.clone().requires_grad_() for a in (x, dt, A, Bm, Cm, D)]
    sti = None if st is None else st.clone().requires_grad_()
    y, fin = ops.ssd_scan(*ins, chunk=Q, init_state=sti)
    assert type(y.grad_fn).__name__ == "_SsdScanBackward"
    assert fin.grad_fn is y.grad_fn
    want_y, want_fin = SSD.ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=Q,
                                          init_state=st)
    assert torch.equal(y.detach(), want_y)
    assert torch.equal(fin.detach(), want_fin)
    g = torch.autograd.grad(y, ins + ([] if sti is None else [sti]), dy)
    _, _, bufs = SSD._ssd_forward(x, dt, A, Bm, Cm, D, Q, st, True)
    want = SSD.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, D, *bufs, dy, None)
    for name, a, b in zip(GRADS, g, want):
        assert torch.equal(a, b), name
    with torch.no_grad():
        y2, _ = ops.ssd_scan(*ins, chunk=Q, init_state=sti)
    assert y2.grad_fn is None and torch.equal(y2, want_y)


def test_ssd_scan_has_a_backward_on_every_input():
    """Only x requiring grad, or only A, or only the initial state: each
    gets its gradient through the Function (the other inputs none)."""
    B, nc, Q, H, P, N = 1, 2, 16, 2, 8, 4
    x, dt, A, Bm, Cm, D, st, dy, _ = map(
        torch.from_numpy, _inputs(B, nc, Q, H, P, N, 7))
    args = [x, dt, A, Bm, Cm, D]
    for i in range(7):
        a = [t.clone() for t in args]
        s = st.clone()
        leaf = (a + [s])[i].requires_grad_()
        y, fin = ops.ssd_scan(*a, chunk=Q, init_state=s)
        (g,) = torch.autograd.grad((y * dy).sum() + fin.sum(), leaf)
        assert g.shape == leaf.shape and bool(torch.isfinite(g).all())
        assert g.abs().max() > 0, GRADS[i]


@pytest.fixture
def fake_kernels(monkeypatch):
    """Run a wrapper's CUDA branch on CPU tensors against a stand-in
    library that records each C call's arguments (no CUDA here)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, args))
                return 0
            return fn

    monkeypatch.setattr(_native, "on_cpu", lambda *a, **k: False)
    monkeypatch.setattr(_native, "library", lambda name: Lib())
    monkeypatch.setattr(_native, "on_device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_native, "current_stream", lambda d: 0)
    ops.reset_launch_counts()
    yield calls
    ops.reset_launch_counts()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dfinal", [False, True])
def test_ssd_function_hands_the_backward_the_forwards_buffers(fake_kernels,
                                                              dtype, dfinal):
    """Under grad on the CUDA branch: one ``repro_ssd_scan_*`` launch whose
    cum, CB and chunk-state scratch are the very buffers the backward's
    ``repro_ssd_scan_bwd_*`` reads (no recompute), the inputs and dy in
    place, d final null unless the final state is used, scratch of the
    documented shapes, the dims (B, S, H, P, N, Q) of mamba2's training
    microbatch; ``ssd_scan`` and ``ssd_scan_bwd`` each counted once."""
    B, S, H, P, N, Q = 4, 512, 80, 64, 128, 256
    nc = S // Q
    x = torch.zeros(B, S, H, P, dtype=dtype, requires_grad=True)
    dt = torch.zeros(B, S, H, requires_grad=True)
    A = torch.zeros(H, requires_grad=True)
    Bm = torch.zeros(B, S, N, dtype=dtype, requires_grad=True)
    Cm = torch.zeros(B, S, N, dtype=dtype, requires_grad=True)
    D = torch.zeros(H, requires_grad=True)
    y, fin = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=Q)
    dy = torch.zeros_like(y)
    outs, grads = [y], [dy]
    if dfinal:
        outs.append(fin)
        grads.append(torch.zeros_like(fin))
    torch.autograd.grad(outs, [x, dt, A, Bm, Cm, D], grads)
    (fname, fa), (bname, ba) = fake_kernels
    sfx = "bf16" if dtype == torch.bfloat16 else "f32"
    assert fname == f"repro_ssd_scan_{sfx}"
    assert bname == f"repro_ssd_scan_bwd_{sfx}"
    assert fa[12:18] == ba[25:31] == (B, S, H, P, N, Q)
    assert ba[31] == SSD.plan_ssd_bwd(B, S, H, P, N, Q, dtype).heads
    # x, dt, A, Bm, Cm, D in place; the forward's cum, cb and states
    assert ba[:6] == tuple(t.data_ptr() for t in (x, dt, A, Bm, Cm, D))
    assert ba[6:9] == fa[9:12]
    assert (ba[10] is None) != dfinal
    assert (ba[24] is None) == (dtype == torch.float32)  # bf16: in_c split
    assert len(ba) == 33 and ba[32] == 0
    counts = ops.launch_counts()
    assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_wrapper_scratch_and_refusals(fake_kernels, monkeypatch,
                                              dtype):
    """The CUDA branch hands the C entry its seven outputs (of the
    documented shapes), six f32 scratch tensors of the documented shapes
    and in bf16 a seventh, in_c's hi + lo halves (no per-head (B, S, H, N)
    or (B, nc, H, Q, Q) scratch: the chunk kernel sums dB, dC and dCB over
    each group of heads on chip), and the plan's group of heads, and
    refuses P > 64 and N > 128 (``ValueError``), the forward's limits."""
    B, S, H, P, N, Q = 2, 64, 3, 8, 4, 32
    nc = S // Q
    t = [torch.from_numpy(a) for a in _inputs(B, nc, Q, H, P, N, 8)]
    for i in (0, 3, 4, 7):   # x, Bm, Cm, dy in the kernel's dtype
        t[i] = t[i].to(dtype)
    cum = torch.zeros(B, nc, H, Q)
    CB = torch.zeros(B, nc, Q, Q)
    ins = torch.zeros(B, nc, H, N, P)
    made = []
    empty = torch.empty

    def recorded(*shape, **kw):
        out = empty(*shape, **kw)
        made.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "empty", recorded)
    out = ops.ssd_scan_bwd(*t[:6], cum, CB, ins, t[7], None)
    monkeypatch.setattr(torch, "empty", empty)
    assert [tuple(o.shape) for o in out] == [
        (B, S, H, P), (B, S, H), (H,), (B, S, N), (B, S, N), (H,),
        (B, H, P, N)]
    plan = SSD.plan_ssd_bwd(B, S, H, P, N, Q, dtype)
    G, tiles = plan.groups, 1
    bf16 = dtype == torch.bfloat16
    scratch = [(B, nc, H, N, P), (B, nc, H, 1), (2, G, B, S, N),
               (G, B, nc, Q, Q), (B, nc, H, tiles, Q), (B, nc, H, tiles)]
    scratch += [(B, nc, H, N, 2 * P)] if bf16 else []
    assert made[-len(scratch):] == scratch
    assert (B, S, H, N) not in made and (B, nc, H, Q, Q) not in made
    assert 4 * sum(int(np.prod(s)) for s in scratch[:6]) + (
        2 * int(np.prod(scratch[6])) if bf16 else 0) == plan.scratch
    (name, args), = fake_kernels
    assert name == f"repro_ssd_scan_bwd_{'bf16' if bf16 else 'f32'}"
    assert args[11:18] == tuple(o.data_ptr() for o in out)
    assert all(isinstance(a, int) for a in args[18:24])   # the scratch
    assert isinstance(args[24], int) if bf16 else args[24] is None
    assert args[25:32] == (B, S, H, P, N, Q, plan.heads)
    for P2, N2 in ((65, 4), (8, 129)):
        x = torch.zeros(B, S, H, P2)
        Bm = torch.zeros(B, S, N2)
        with pytest.raises(ValueError, match="P <= 64"):
            ops.ssd_scan_bwd(x.to(dtype), t[1], t[2], Bm.to(dtype),
                             Bm.to(dtype), t[5], cum, CB,
                             torch.zeros(B, nc, H, N2, P2),
                             torch.zeros_like(x).to(dtype), None)


# ---------------------------------------------------------------------------
# the ssm and hybrid families through loss_fn
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _reference_on_the_recurrent_oracle():
    """The reference's model with its SSD core on ``ssd_naive_ref``: its
    chunked scan's gradient is NaN at these weights (module docstring)."""
    chunked = RS.ssd_chunked

    def naive(x, dt, A, Bm, Cm, D, *, chunk, init_state=None):
        assert init_state is None
        return R.ssd_naive_ref(x, dt, A, Bm, Cm, D)

    RS.ssd_chunked = naive
    try:
        yield
    finally:
        RS.ssd_chunked = chunked


def _cfgs(arch, **over):
    over.setdefault("dtype", "float32")
    over.setdefault("num_layers", DEPTH[arch])
    return (ref_get_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _params(rcfg, seed=0):
    rp = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    return rp, T.from_reference(jax.tree.map(np.asarray, rp))


def _tokens(cfg, B, S, seed=0):
    toks = _rng(B, S, seed).integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _requires_grad(params):
    leaves = pytree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def _leaf_rels(got_tree, ref_tree):
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    got = pytree.flatten_with_path(got_tree)
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    return [(k, _rel(g, r)) for (k, g), (_, r) in zip(got, ref)]


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(arch):
    """(loss, the reference's gradient tree) of the reduced ``arch`` on a
    (2, 64) batch, seed 0, its SSD core on the recurrent oracle."""
    rcfg, _ = _cfgs(arch)
    rp, _ = _params(rcfg)
    rb, _ = _tokens(rcfg, 2, 64)
    with _reference_on_the_recurrent_oracle():
        (rl, _), rg = jax.jit(jax.value_and_grad(
            lambda p, b: RT.loss_fn(p, b, rcfg), has_aux=True))(rp, rb)
    return float(rl), rg


def test_reference_chunked_gradient_overflows_at_these_weights():
    """Why the model-level references run on the recurrent oracle: at the
    reduced mamba2's weights the reference's own ``jax.grad`` through its
    chunked scan is not finite, while the port's gradient is."""
    rcfg, cfg = _cfgs("mamba2-2.7b")
    rp, pp = _params(rcfg)
    rb, pb = _tokens(rcfg, 2, 64)
    rg = jax.jit(jax.grad(lambda p, b: RT.loss_fn(p, b, rcfg)[0]))(rp, rb)
    assert not all(np.isfinite(np.asarray(a)).all()
                   for a in jax.tree.leaves(rg))
    leaves = _requires_grad(pp)
    total, _ = T.loss_fn(pp, pb, cfg)
    assert all(bool(torch.isfinite(g).all())
               for g in torch.autograd.grad(total, leaves))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch, remat):
    """Reduced mamba2 (2 layers) and zamba2 (4 layers, 2 groups), f32, a
    (2, 64) batch: ``loss_fn``'s total and every gradient leaf (the mamba
    weights, A_log, D, dt_bias, the convs, norms, embed and, for zamba2,
    the shared attention block) against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, with and without remat: the loss within 1e-5
    relative, each leaf within 1e-4 of its max|ref|."""
    rl, rg = _reference_value_and_grad(arch)
    _, cfg = _cfgs(arch)
    _, pp = _params(_cfgs(arch)[0])
    _, pb = _tokens(cfg, 2, 64)
    leaves = _requires_grad(pp)
    total, m = T.loss_fn(pp, pb, cfg, remat=remat)
    assert abs(total.item() - rl) <= 1e-5 * abs(rl)
    assert m["aux_loss"].item() == 0.0
    grads = pytree.unflatten(pp, torch.autograd.grad(total, leaves))
    rels = _leaf_rels(grads, rg)
    assert any("A_log" in k for k, _ in rels)
    assert any("shared" in k for k, _ in rels) == (arch == "zamba2-2.7b")
    for key, rel in rels:
        assert rel <= 1e-4, (key, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_no_remat(arch):
    """``remat=True`` (one mamba block a checkpoint for ssm, one group of
    mamba blocks and the shared block for hybrid, ``remat_group`` ignored)
    gives the loss and every gradient leaf bit for bit as without remat,
    and runs ``ssd_scan`` once more a mamba layer (its recompute) and
    ``ssd_scan_bwd`` once a layer."""
    _, cfg = _cfgs(arch)
    pp = T.init_params(cfg, torch.Generator().manual_seed(1))
    _, pb = _tokens(cfg, 2, 64, 1)
    leaves = _requires_grad(pp)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = SSD.ssd_cum_cb, SSD.ssd_scan_bwd_plain

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    runs = []
    try:
        SSD.ssd_cum_cb = count("fwd", fwd)
        SSD.ssd_scan_bwd_plain = count("bwd", bwd)
        for remat, group in ((False, 1), (True, 1), (True, 2), (False, 1)):
            calls.update(fwd=0, bwd=0)
            total, _ = T.loss_fn(pp, pb, cfg, remat=remat, remat_group=group)
            runs.append([total] + list(torch.autograd.grad(total, leaves)))
            L = cfg.num_layers
            assert calls == {"fwd": L * (2 if remat else 1), "bwd": L}
    finally:
        SSD.ssd_cum_cb, SSD.ssd_scan_bwd_plain = fwd, bwd
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.parametrize("arch", ARCHS)
def test_no_grad_forward_is_unchanged(arch):
    """Without grad the forward takes ``ssd_scan``'s inference path (no
    Function, no kept buffers) and gives the same logits as under grad."""
    _, cfg = _cfgs(arch)
    pp = T.init_params(cfg, torch.Generator().manual_seed(2))
    _, pb = _tokens(cfg, 1, 32, 2)
    with torch.no_grad():
        lg, aux, _ = T.forward(pp, pb, cfg, remat=True)
    assert lg.grad_fn is None and aux.item() == 0.0
    _requires_grad(pp)
    lg2, _, _ = T.forward(pp, pb, cfg)
    assert lg2.grad_fn is not None and torch.equal(lg, lg2.detach())


# ---------------------------------------------------------------------------
# the train step and the launcher
# ---------------------------------------------------------------------------
def _ill_conditioned(rm, rm_prev, bad):
    """``bad`` (a list of bool arrays, one a leaf, or None) or-ed with the
    elements whose gradient this step, read back from the reference's
    first moments (g = (m − 0.9·m_prev) / 0.1), is under 1e3·eps: AdamW's
    step m̂/(√v̂ + eps) turns such an element, whose f32 rounding differs
    between the recurrent oracle and the chunked scan, into a step of any
    size up to lr, and the params carry it into every later step."""
    now = [np.abs((np.asarray(m, np.float32) - 0.9 * np.asarray(
        q, np.float32)) / 0.1) < 1e3 * 1e-8
        for m, q in zip(jax.tree.leaves(rm), jax.tree.leaves(rm_prev))]
    return now if bad is None else [a | b for a, b in zip(bad, now)]


def _step_param_rels(pp, rp, bad, lr_sum):
    """Each param leaf's max|d|/max|ref| over the elements whose AdamW
    steps were all well conditioned (``_ill_conditioned``: there a gradient
    error δ moves the step by at most eps/|g| ≤ 1e-3 of δ/|g|); the others
    must stay within ``lr_sum``, the steps' summed lr, and be under a
    quarter of the leaf (3 of A_log's 16 elements, under 14 % elsewhere)."""
    ref = jax.tree_util.tree_flatten_with_path(rp)[0]
    got = pytree.flatten_with_path(pp)
    assert [k for k, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    out = []
    for (k, g), (_, r), off in zip(got, ref, bad):
        g, r = _np(g), _np(r)
        d = np.abs(g - r)
        assert off.mean() < 0.25 and (d[off] <= lr_sum).all(), k
        out.append((k, float(d[~off].max(initial=0.0)
                             / max(np.abs(r).max(), 1e-30))))
    return out


@pytest.mark.parametrize("arch,microbatches", [("mamba2-2.7b", 1),
                                               ("zamba2-2.7b", 2)])
def test_train_step_matches_reference(arch, microbatches):
    """Two ``make_train_step`` steps (remat on) against the reference's
    jitted step (its SSD core on the recurrent oracle) on the same
    ``SyntheticPipeline`` data: the f32 moments and the metrics (loss, grad
    norm, lr) within 1e-4 of max|ref|, the params updated in place and
    within 1e-4 of max|ref| wherever AdamW's step is well conditioned
    (``_step_param_rels``)."""
    rcfg, cfg = _cfgs(arch, vocab_size=256)
    kw = dict(lr=3e-4, warmup=100, total_steps=1000,
              num_microbatches=microbatches)
    rpipe = RefPipeline(rcfg, 4, 32, microbatches=microbatches, seed=3)
    ppipe = SyntheticPipeline(cfg, 4, 32, microbatches=microbatches, seed=3,
                              device="cpu")
    rp, pp = _params(rcfg, seed=5)
    rs, ps = RA.adamw_init(rp), PA.adamw_init(pp)
    step = make_train_step(cfg, remat=True, **kw)
    ids = [id(p) for p in pytree.leaves(pp)]
    lr_sum, bad = 0.0, None
    with _reference_on_the_recurrent_oracle():
        ref_step = jax.jit(ref_make_train_step(rcfg, remat=False, **kw))
        for i in range(2):
            m_prev = rs.m
            rp, rs, rm = ref_step(rp, rs, rpipe.batch_at(i))
            pp, ps, pm = step(pp, ps, ppipe.batch_at(i))
            lr_sum += float(rm["lr"])
            bad = _ill_conditioned(rs.m, m_prev, bad)
            assert [id(p) for p in pytree.leaves(pp)] == ids
            for k in ("loss", "grad_norm", "lr"):
                assert abs(float(pm[k]) - float(rm[k])) <= 1e-4 * abs(
                    float(rm[k])), (i, k)
            for key, rel in (_leaf_rels(ps.m, rs.m) + _leaf_rels(ps.v, rs.v)
                             + _step_param_rels(pp, rp, bad, lr_sum)):
                assert rel <= 1e-4, (i, key, rel)


def test_launch_train_mamba2_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch mamba2-2.7b --reduced
    --device cpu`` runs its steps with finite losses."""
    from repro_torch.launch import train as LT

    final = LT.main(["--arch", "mamba2-2.7b", "--device", "cpu", "--reduced",
                     "--steps", "2", "--batch", "2", "--seq", "64"])
    out = capsys.readouterr().out
    losses = [float(l.split()[3]) for l in out.splitlines()
              if l.startswith("step")]
    assert "mamba2-2.7b-reduced" in out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] == pytest.approx(final, abs=1e-4)
