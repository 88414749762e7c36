"""Gradients of the port's kernels on the CPU: the ``matmul`` and
``flash_attention`` autograd Functions and ``flash_attention_bwd_plain``
against ``jax.vjp`` of the reference's oracles (``matmul_ref``,
``flash_attention_ref``), the wrappers' CUDA branch (forward and backward
launches, the lse and scratch pointers, ``w`` read in place) through a
stand-in library, and every kernel wrapper without a backward refusing
gradients. Inputs come from numpy seeds.

Tolerances:
* f32: 1e-5 of max|ref| per gradient (the same f32 arithmetic in another
  order);
* bf16: 2e-2 of max|ref| (``KERNEL_TOL``'s bf16 gate: the port rounds q, k,
  v, o and the gradients to bf16 at other places than XLA);
* the lse of the plain forward: 1e-5 absolute against numpy's
  logsumexp of the same masked scores in f64.
"""
import contextlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import flash_attention_ref, matmul_ref  # noqa: E402
from repro_torch.kernels import _native, ops  # noqa: E402
from repro_torch.kernels import attention as A  # noqa: E402

torch.set_num_threads(1)


def _rng(*key):
    return np.random.default_rng(list(key))


def _rel(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _jax_dtype(dtype):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _tensor(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # B, S, H, KV, D, causal, window, softcap
    (2, 24, 4, 2, 64, True, None, None),
    (1, 40, 4, 1, 80, True, 7, None),
    (1, 33, 2, 2, 64, True, None, 5.0),
    (2, 20, 6, 3, 80, False, None, None),
    (1, 30, 4, 2, 64, False, 9, 3.0),
    (1, 37, 6, 2, 80, True, 11, 2.5),
]


def _flash_inputs(B, S, H, KV, D, seed=0):
    rng = _rng(B, S, H, KV, D, seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _flash_ref_grads(q, k, v, do, dtype, **kw):
    """``jax.vjp`` of ``flash_attention_ref`` (jitted: one compile, rather
    than one a primitive)."""
    jd = _jax_dtype(dtype)

    @jax.jit
    def grads(a, b, c, g):
        _, vjp = jax.vjp(lambda x, y, z: flash_attention_ref(x, y, z, **kw),
                         a, b, c)
        return vjp(g)

    return [np.asarray(g, np.float32)
            for g in grads(*(jnp.asarray(x, jd) for x in (q, k, v, do)))]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_flash_bwd_plain_and_function_match_jax_grad(case):
    """``flash_attention_bwd_plain`` (fed the plain forward's o and lse)
    and the autograd Function's gradients equal ``jax.vjp`` of
    ``flash_attention_ref`` in f32 over causal, window, softcap, GQA and
    D 64 and 80."""
    B, S, H, KV, D, causal, window, softcap = case
    kw = dict(causal=causal, window=window, softcap=softcap)
    q, k, v, do = _flash_inputs(B, S, H, KV, D)
    want = _flash_ref_grads(q, k, v, do, "float32", **kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = A.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = A.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    for g, w in zip(got, want):
        assert _rel(_np(g), w) <= 1e-5
    # the Function: ops.flash_attention under grad, backward through the
    # wrapper's CPU branch
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None
    out.backward(tdo)
    for t, w in zip(leaves, want):
        assert _rel(_np(t.grad), w) <= 1e-5


def test_flash_plain_lse_is_the_rows_logsumexp():
    """The lse the plain forward returns (what the Function saves) is each
    row's log-sum-exp of its scaled, softcapped, masked scores."""
    B, S, H, KV, D = 1, 19, 2, 1, 64
    q, k, v, _ = _flash_inputs(B, S, H, KV, D, seed=3)
    _, lse = A.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k,
                                                                     v)),
                                     causal=True, window=5, softcap=4.0,
                                     return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    kf = np.repeat(k.astype(np.float64), H // KV, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kf) / math.sqrt(D)
    s = np.tanh(s / 4.0) * 4.0
    i = np.arange(S)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 5)
    s = np.where(mask, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert np.abs(lse.numpy() - want).max() <= 1e-5


def test_flash_bwd_bf16_matches_jax_grad():
    """bf16 inputs: the Function's gradients within the bf16 gate of
    ``jax.vjp`` of ``flash_attention_ref`` on the same bf16 inputs."""
    B, S, H, KV, D = 1, 32, 4, 2, 64
    kw = dict(causal=True, window=12, softcap=None)
    q, k, v, do = _flash_inputs(B, S, H, KV, D, seed=1)
    want = _flash_ref_grads(q, k, v, do, "bfloat16", **kw)
    leaves = [_tensor(x, "bfloat16").requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, **kw)
    out.backward(_tensor(do, "bfloat16"))
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16
        assert _rel(_np(t.grad), w) <= 2e-2


def _mma_route_emulation(q, k, v, o, lse, do, causal, window, softcap):
    """The tensor-core route's arithmetic (``csrc/flash_attention_bwd.cu``,
    ``fab_mma_*_kernel``) in torch f32 on bf16 inputs: the score and dO·vᵀ
    products summed in f32; P = exp(s - lse) and dS = P∘(dP - δ)[·(1 -
    t²)]·scale formed in f32 and each rounded once to bf16 before its
    products (dV = Pᵀ·dO, dK = dSᵀ·q, dQ = dS·k, summed in f32); δ =
    rowsum(dO∘o) in f32; each gradient rounded to bf16 once."""
    f, b = torch.float32, torch.bfloat16
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    qf, kf, vf, of, dof = (t.to(f) for t in (q, k, v, o, do))
    kf, vf = (t.repeat_interleave(rep, dim=2) for t in (kf, vf))
    scale = 1.0 / math.sqrt(D)
    x = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    t = torch.zeros_like(x)
    if softcap:
        t = torch.tanh(x / softcap)
        x = softcap * t
    mask = A._mask(S, causal, window, q.device)
    p = torch.where(mask, torch.exp(x - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta) * (1 - t * t) * scale
    pb, dsb = p.to(b).to(f), ds.to(b).to(f)
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dof)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kf)
    KV = k.shape[2]
    dk = dk.reshape(B, S, KV, rep, D).sum(3)
    dv = dv.reshape(B, S, KV, rep, D).sum(3)
    return dq.to(b), dk.to(b), dv.to(b)


@pytest.mark.parametrize("case", [
    # B, S, H, KV, D, causal, window, softcap
    (2, 40, 6, 2, 64, True, None, None),     # causal, GQA
    (1, 48, 4, 2, 80, True, 9, 5.0),         # window + softcap
    (1, 37, 4, 1, 67, True, None, None),     # ragged, D off the grid
], ids=["causal_gqa", "window_softcap", "ragged_d67"])
def test_flash_bwd_mma_rounding_matches_jax_grad(case):
    """The tensor-core route's rounding points (P and dS rounded to bf16
    before their products), emulated at a small shape on bf16 inputs with
    the plain forward's o and lse: within 2e-2 of ``jax.vjp`` of
    ``flash_attention_ref`` on the same bf16 inputs and of
    ``flash_attention_bwd_plain`` (unrounded P and dS), per gradient; the
    route ``plan_flash_bwd`` gives that shape is the tensor cores."""
    B, S, H, KV, D, causal, window, softcap = case
    kw = dict(causal=causal, window=window, softcap=softcap)
    assert A.plan_flash_bwd(B, S, H, KV, D, torch.bfloat16, causal,
                            window).route == "mma"
    q, k, v, do = _flash_inputs(B, S, H, KV, D, seed=5)
    want = _flash_ref_grads(q, k, v, do, "bfloat16", **kw)
    tq, tk, tv, tdo = (_tensor(x, "bfloat16") for x in (q, k, v, do))
    o, lse = A.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = _mma_route_emulation(tq, tk, tv, o, lse, tdo, causal, window,
                               softcap)
    plain = A.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, **kw)
    for g, w, pl in zip(got, want, plain):
        assert g.dtype == torch.bfloat16
        assert _rel(_np(g), w) <= 2e-2
        assert _rel(_np(g), _np(pl)) <= 2e-2


def test_plan_flash_bwd_routes_and_tiles():
    """``plan_flash_bwd`` from the shapes and masks alone: bf16 heads up to
    128 on the tensor cores, D padded to a multiple of 16 (64, 80, 128; 67
    to 80), 64-row blocks of 4 warps (a dK/dV block split over two warp
    groups where its heaviest block sets the time), 64-row tiles of DP + 8
    bf16 and the ring's lse and δ in shared memory; a 256-wide bf16 head
    and every f32
    shape on the CUDA cores at the forward's widths (f32 D 80 at 96), in
    64-row tiles (32 above 128) of 256 threads; D past 256 refused."""
    bf, f32 = torch.bfloat16, torch.float32
    for D, dp in ((64, 64), (80, 80), (128, 128), (67, 80), (16, 16)):
        p = A.plan_flash_bwd(4, 512, 15, 5, D, bf)
        assert (p.route, p.dp, p.rows, p.threads) == ("mma", dp, 64, 128)
        tile = 64 * (dp + 8) * 2
        assert p.smem == 6 * tile + 4 * 64 * 4
        assert p.smem_dkdv == (2 + 4 * p.split) * tile + 4 * p.split * 256
        assert (p.blocks_dkdv, p.blocks_dq) == (4 * 5 * 8, 4 * 15 * 8)
    # the causal smollm-360m microbatch: 160 dK/dV blocks, the first key
    # tile's holding 3 heads x 8 query tiles, so two warp groups share
    # them; its batch of 8 (320 blocks), zamba2's (4, 512, 32/32, 80)
    # (1024) and a windowed (1, 1024, 32/16, 128) (256) fill the card
    assert A.plan_flash_bwd(4, 512, 15, 5, 64, bf).split == 2
    for shape in ((8, 512, 15, 5, 64), (4, 512, 32, 32, 80),
                  (1, 1024, 32, 16, 128)):
        assert A.plan_flash_bwd(*shape, bf, True, 256).split == 1
    p = A.plan_flash_bwd(1, 256, 4, 4, 256, bf)
    assert (p.route, p.dp, p.rows, p.threads, p.split) == ("simt", 256, 32,
                                                           256, 1)
    assert (p.blocks_dkdv, p.blocks_dq) == (4 * 8, 4 * 8)
    for D, dp in ((64, 64), (80, 96), (128, 128)):
        p = A.plan_flash_bwd(8, 512, 15, 5, D, f32)
        assert (p.route, p.dp, p.rows, p.threads) == ("simt", dp, 64, 256)
    # the masks change no route, width or tile
    assert A.plan_flash_bwd(1, 1024, 32, 16, 128, bf, True, 256)[:3] == \
        A.plan_flash_bwd(1, 1024, 32, 16, 128, bf, False, None)[:3]
    with pytest.raises(ValueError, match="head_dim"):
        A.plan_flash_bwd(1, 64, 2, 1, 300, bf)


def test_flash_inference_takes_no_function():
    """Without grad (grad mode off, or no input requiring grad) the call is
    the plain wrapper: no ``grad_fn``."""
    q, k, v, _ = _flash_inputs(1, 8, 2, 1, 32)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert ops.flash_attention(tq, tk, tv).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(tq.requires_grad_(), tk, tv).grad_fn \
            is None


def test_flash_bwd_refuses_bad_shapes():
    q = torch.zeros(1, 8, 2, 32)
    k = torch.zeros(1, 8, 1, 32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        A.flash_attention_bwd(q, k, k, q, lse[:, :, :4], q)
    with pytest.raises(ValueError):
        A.flash_attention_bwd(q, k, k, q[:, :4], lse, q)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kmajor", [False, True], ids=["row_major",
                                                      "k_major"])
def test_matmul_function_matches_jax_grad(dtype, kmajor):
    """dx and dw of ``ops.matmul`` under grad equal ``jax.vjp`` of
    ``matmul_ref``, with w row-major or K-major (a transposed view, read
    in place), each gradient in its input's dtype."""
    rng = _rng(7, int(kmajor))
    M, K, N = 13, 48, 40
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / 7).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    jd = _jax_dtype(dtype)
    _, vjp = jax.vjp(matmul_ref, jnp.asarray(x, jd), jnp.asarray(w, jd))
    want = vjp(jnp.asarray(dy, jd))
    tx = _tensor(x, dtype).requires_grad_()
    if kmajor:
        base = _tensor(np.ascontiguousarray(w.T), dtype).requires_grad_()
        tw = base.T
        assert not tw.is_contiguous() and tw.T.is_contiguous()
    else:
        base = tw = _tensor(w, dtype).requires_grad_()
    y = ops.matmul(tx, tw)
    assert y.grad_fn is not None and y.dtype == tx.dtype
    y.backward(_tensor(dy, dtype))
    gw = base.grad.T if kmajor else base.grad
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert tx.grad.dtype == gw.dtype == getattr(torch, dtype)
    assert _rel(_np(tx.grad), want[0]) <= tol
    assert _rel(_np(gw), want[1]) <= tol


def test_tied_head_gradient_reaches_embed():
    """The tied head ``_mm(h, embed.T)`` (3-D h, embed read K-major in
    place) and an embedding read of the same table: ``embed``'s gradient is
    the sum of both, as ``jax.grad`` gives it."""
    from repro_torch.models import layers as L

    rng = _rng(11)
    V, d, B, S = 50, 32, 2, 6
    emb = (rng.standard_normal((V, d)) * 0.02).astype(np.float32)
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    g = rng.standard_normal((B, S, V)).astype(np.float32)

    def f(e, hh):
        return jnp.sum(matmul_ref((hh + e[toks]).reshape(-1, d), e.T)
                       .reshape(B, S, V) * g)

    want = jax.grad(f, argnums=(0, 1))(jnp.asarray(emb), jnp.asarray(h))
    te = torch.from_numpy(emb).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    x = th + torch.nn.functional.embedding(torch.from_numpy(toks), te)
    (L._mm(x, te.T) * torch.from_numpy(g)).sum().backward()
    assert _rel(_np(te.grad), want[0]) <= 1e-5
    assert _rel(_np(th.grad), want[1]) <= 1e-5


def test_matmul_inference_takes_no_function():
    x, w = torch.randn(3, 4), torch.randn(4, 5)
    assert ops.matmul(x, w).grad_fn is None
    with torch.no_grad():
        assert ops.matmul(x.requires_grad_(), w).grad_fn is None


# ---------------------------------------------------------------------------
# the CUDA branch through a stand-in library
# ---------------------------------------------------------------------------
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_backward_launches_two_gemms_w_in_place(fake_kernels, dtype):
    """Under grad, the tied head's ``x @ embed.T`` launches one GEMM
    forward (embed K-major) and two backward: dx reads ``embed`` itself
    row-major (its storage, no copy), dw takes ``x.T`` as a new contiguous
    (K, M) operand and dy; three launches counted."""
    dt = getattr(torch, dtype)
    M, d, V = 8, 32, 48
    emb = torch.zeros(V, d, dtype=dt, requires_grad=True)
    x = torch.zeros(M, d, dtype=dt, requires_grad=True)
    y = ops.matmul(x, emb.T)
    y.backward(torch.zeros(M, V, dtype=dt))
    names = [n for n, _ in fake_kernels]
    fn = "repro_matmul_bf16" if dtype == "bfloat16" else "repro_matmul_f32"
    assert names == [fn] * 3
    (_, fwd), (_, bwd1), (_, bwd2) = fake_kernels
    # x, w, out, M, N, K, ldb, kmajor
    assert fwd[1] == emb.data_ptr() and fwd[3:8] == (M, V, d, d, 1)
    assert fwd[0] == x.data_ptr()
    # dx = dy (M, V) @ embed (V, d), embed row-major in place
    assert bwd1[1] == emb.data_ptr() and bwd1[3:8] == (M, d, V, d, 0)
    # dw = x.T (d, M) @ dy (M, V): a copy of x, not x's storage
    assert bwd2[0] != x.data_ptr() and bwd2[3:8] == (d, V, M, V, 0)
    key = "matmul_bf16" if dtype == "bfloat16" else "matmul"
    assert ops.launch_counts()[key] == 3


def test_flash_function_passes_lse_and_bwd_its_args(fake_kernels):
    """Under grad the forward hands ``repro_flash_attention_bf16`` an lse
    buffer (inference passes None); the backward reaches
    ``repro_flash_attention_bwd_bf16`` with that lse, a delta scratch, the
    masks, softcap, the padded width, the tensor-core route and the
    planned split, one launch counted each."""
    B, S, H, KV, D = 2, 100, 6, 2, 80
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros(B, S, KV, D, dtype=torch.bfloat16, requires_grad=True)
    v = torch.zeros(B, S, KV, D, dtype=torch.bfloat16, requires_grad=True)
    out = ops.flash_attention(q, k, v, causal=True, window=33, softcap=7.5)
    out.backward(torch.zeros_like(out))
    (n1, fwd), (n2, bwd) = fake_kernels
    assert n1 == "repro_flash_attention_bf16"
    assert n2 == "repro_flash_attention_bwd_bf16"
    assert fwd[4] is not None and bwd[5] == fwd[4]       # the same lse
    assert bwd[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert bwd[3] == fwd[3]                               # o
    assert bwd[6] is not None                             # delta scratch
    assert bwd[10:18] == (B, S, H, KV, D, 1, 33, 7.5)
    plan = A.plan_flash_bwd(B, S, H, KV, D, torch.bfloat16, True, 33)
    assert bwd[18:21] == (80, 1, plan.split)     # dp, the mma route, split
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1


def test_flash_bwd_f32_pads_d_to_the_forwards_widths(fake_kernels):
    """f32 at D 80 runs the backward at the f32 forward's width 96."""
    q = torch.zeros(1, 64, 2, 80)
    k = torch.zeros(1, 64, 1, 80)
    A.flash_attention_bwd(q, k, k, q, torch.zeros(1, 2, 64), q)
    (name, args), = fake_kernels
    assert name == "repro_flash_attention_bwd_f32"
    assert args[10:18] == (1, 64, 2, 1, 80, 1, 0, 0.0) and args[18] == 96


# ---------------------------------------------------------------------------
# wrappers without a backward refuse gradients
# ---------------------------------------------------------------------------
def _no_backward_calls():
    """(name, call) for each kernel wrapper without a backward; ``call(rg)``
    runs it with one float input requiring grad where ``rg``."""
    from repro_torch import quant as Qm

    def decode(rg):
        return ops.decode_attention(
            torch.randn(1, 2, 8, requires_grad=rg), torch.randn(1, 4, 2, 8),
            torch.randn(1, 4, 2, 8), torch.tensor([3], dtype=torch.int32))

    def packed(rg):
        return ops.matmul_packed(torch.randn(2, 128, requires_grad=rg),
                                 torch.randn(1, 1, 128, 128), 128, 128)

    def wino(rg):
        return ops.winograd_tile_matmul(
            torch.randn(16, 4, 3, requires_grad=rg), torch.randn(16, 3, 5))

    w = np.random.default_rng(5).standard_normal((16, 8)).astype(np.float32)
    q8, s8, _ = Qm.quantize_int8(w)
    q4, s4 = Qm.quantize_int4(w)
    q8, s8, q4, s4 = (torch.from_numpy(np.ascontiguousarray(a))
                      for a in (q8, s8, q4, s4))

    def scale(s, rg):
        return s.clone().requires_grad_(rg)

    def gmm(rg):
        return ops.gmm_blocks(torch.randn(2, 3, 8, requires_grad=rg),
                              torch.randn(2, 8, 4))

    return [
        ("decode_attention", decode),
        ("matmul_packed", packed),
        ("winograd_tile_matmul", wino),
        ("dequant_int8", lambda rg: ops.dequant_int8(q8, scale(s8, rg))),
        ("dequant_int4", lambda rg: ops.dequant_int4(q4, scale(s4, rg),
                                                     K=16)),
        ("matmul_dequant_int8", lambda rg: ops.matmul_dequant_int8(
            torch.randn(3, 16, requires_grad=rg), q8, s8)),
        ("matmul_dequant_int4", lambda rg: ops.matmul_dequant_int4(
            torch.randn(3, 16, requires_grad=rg), q4, s4, K=16)),
        ("gmm_blocks", gmm),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _no_backward_calls()])
def test_wrappers_without_backward_refuse_grad(name):
    """Each wrapper with no backward kernel raises ``NotImplementedError``
    naming itself when grad mode is on and an input requires grad, rather
    than return a tensor with no ``grad_fn``; without grad it runs."""
    call = dict(_no_backward_calls())[name]
    with pytest.raises(NotImplementedError, match=name):
        call(True)
    out = call(False)
    with torch.no_grad():
        call(True)
    assert out is not None


def test_ssd_scan_has_a_backward():
    """``ssd_scan`` left the wrappers without a backward: under grad it
    returns the outputs of its autograd Function (a ``grad_fn``, the
    gradient reaching x), under ``torch.no_grad()`` plain tensors."""
    B, S, H, P, N = 1, 8, 2, 4, 4
    x = torch.randn(B, S, H, P, requires_grad=True)
    args = (torch.rand(B, S, H), -torch.rand(H), torch.randn(B, S, N),
            torch.randn(B, S, N), torch.randn(H))
    y, final = ops.ssd_scan(x, *args, chunk=4)
    assert y.grad_fn is not None and final.grad_fn is not None
    (gx,) = torch.autograd.grad(y.sum(), x)
    assert gx.shape == x.shape and bool(torch.isfinite(gx).all())
    with torch.no_grad():
        y2, _ = ops.ssd_scan(x, *args, chunk=4)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())
