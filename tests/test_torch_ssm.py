"""The port's SSM slice (``kernels.ssd.ssd_scan``, ``models.ssm``, the ssm
branch of ``models.transformer``) against the JAX package's, on the CPU at
small size. Inputs come from numpy seeds; the reference makes the params
(``jax.random``) and ``transformer.from_reference`` carries them over.

Tolerances:
* ``ssd_scan_plain`` against the Pallas ``ssd_scan`` (``interpret=True``)
  and ``ref.ssd_naive_ref``: atol 2e-4, rtol 2e-3, the reference sweep's
  own (``test_kernels.py``); against ``ssm.ssd_chunked``, y and the final
  state, with and without an initial state: 1e-5 (the same f32 chunk
  arithmetic, another summation order); the sweep of the plain version's
  four phases (1, 2, 4 and 8 chunks, Q 96, N 16 to 128, P 32 and 64)
  against both: atol 2e-4, rtol 2e-3, the existing sweep's;
* ``causal_conv``, ``ssd_decode_step``, ``mamba_apply_seq`` and
  ``mamba_decode_step``: 1e-5 in f32; in bf16 5e-2, the reference sweep's
  bf16 tolerance (``test_kernels.py``): a bf16 ulp is 2^-8 of a value, the
  SiLU rounds once in the port where the reference rounds its sigmoid and
  its product, and the output projection sums terms of order 1 into
  values near 0; the f32 states of a bf16 mixer as well;
* ``forward`` and ``decode_step`` logits: 1e-4 on f32 configs; atol 0.1,
  rtol 0.05 on bf16 ones, the reference's gate for LLM logits
  (``test_llm_graph.py``);
* the port's decode against its own forward: 0.08, the reference's own
  bound (``test_decode_consistency.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.ssd import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch import bf16  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import _native  # noqa: E402
from repro_torch.kernels import ssd as SSD  # noqa: E402
from repro_torch.kernels.ssd import plan_ssd, ssd_scan_plain  # noqa: E402
from repro_torch.models import ssm as SM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

torch.set_num_threads(1)
ARCH = "mamba2-2.7b"


def _rng(*key):
    return np.random.default_rng(list(key))


def _np(a):
    return np.asarray(a, np.float32)


def _t(a):
    return bf16.to_tensor(np.array(a))


def _from_ref(tree):
    return T.from_reference(jax.tree.map(np.asarray, tree))


def _ssd_inputs(B, S, H, P, N, seed=0):
    rng = _rng(B, S, H, P, N, seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.3
    dt = np.abs(rng.standard_normal((B, S, H))).astype(np.float32) * 0.3
    A = -np.linspace(0.5, 2.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((B, S, N)).astype(np.float32) * 0.3
    D = np.ones((H,), np.float32)
    st = rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.3
    return x, dt, A, Bm, Cm, D, st


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------------------
# ssd_scan: the plain version against the Pallas kernel and the oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,H,P,N,chunk", [(256, 4, 64, 32, 64),
                                           (128, 2, 32, 16, 32),
                                           (192, 4, 64, 64, 64)])
def test_ssd_scan_plain_matches_pallas(S, H, P, N, chunk):
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(2, S, H, P, N)
    want = pallas_ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), chunk=chunk,
                      interpret=True)
    naive, naive_state = R.ssd_naive_ref(
        *map(jnp.asarray, (x, dt, A, Bm[:, :, None], Cm[:, :, None], D)))
    before = ops.launch_counts()["ssd_scan"]
    y, state = ops.ssd_scan(*_torch(x, dt, A, Bm, Cm, D), chunk=chunk)
    assert ops.launch_counts()["ssd_scan"] == before  # CPU: plain version
    assert y.shape == x.shape and state.shape == (2, H, P, N)
    for ref in (want, naive):
        np.testing.assert_allclose(y.numpy(), _np(ref), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(state.numpy(), _np(naive_state), atol=2e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_plain_matches_ssd_chunked(chunk, init):
    """y and the final state, from a zero or a given initial state."""
    x, dt, A, Bm, Cm, D, st = _ssd_inputs(2, 128, 3, 16, 8, seed=chunk)
    st = st if init else None
    y_r, s_r = RS.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm[:, :, None], Cm[:, :, None], D)),
        chunk=chunk, init_state=None if st is None else jnp.asarray(st))
    y, s = ssd_scan_plain(*_torch(x, dt, A, Bm, Cm, D), chunk=chunk,
                          init_state=None if st is None
                          else torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), _np(y_r), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), _np(s_r), atol=1e-5, rtol=1e-5)
    # the model-level wrapper takes (B,S,G,N) with G = 1 and the same state
    y2, s2 = SM.ssd_chunked(*_torch(x, dt, A, Bm[:, :, None], Cm[:, :, None],
                                    D), chunk=chunk,
                            init_state=None if st is None
                            else torch.from_numpy(st))
    assert torch.equal(y2, y) and torch.equal(s2, s)


def test_ssd_scan_state_carries_across_calls():
    """Two halves, the second from the first's final state, give the whole
    sequence's y and state (what a chunked prefill continuing a prompt
    needs)."""
    x, dt, A, Bm, Cm, D, _ = _ssd_inputs(1, 128, 2, 16, 8, seed=3)
    args = _torch(x, dt, A, Bm, Cm, D)
    y, s = ssd_scan_plain(*args, chunk=32)
    half = [a[:, :64] if a.dim() > 1 else a for a in args]
    rest = [a[:, 64:] if a.dim() > 1 else a for a in args]
    y1, s1 = ssd_scan_plain(*half, chunk=32)
    y2, s2 = ssd_scan_plain(*rest, chunk=32, init_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), atol=1e-5, rtol=1e-5)


def test_ssd_scan_wrapper_checks():
    x, dt, A, Bm, Cm, D, st = _torch(*_ssd_inputs(1, 64, 2, 8, 4))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=24)        # 64 % 24 != 0
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, Bm[:, :32], Cm, D, chunk=16)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=16, init_state=st[:, :1])
    with pytest.raises(NotImplementedError):
        SM.ssd_chunked(x, dt, A, torch.stack([Bm, Bm], 2),
                       torch.stack([Cm, Cm], 2), D, chunk=16)


# ---------------------------------------------------------------------------
# the kernels' four phases (ssd_scan_plain) and plan_ssd
# ---------------------------------------------------------------------------
# (nc, Q, N, P, init): 1, 2, 4 and 8 chunks; a Q that is not a multiple of
# 64 (96) with and without an initial state; N 16, 64 and 128; P 32 and 64
PHASE_SWEEP = [(1, 64, 16, 32, False), (2, 96, 64, 64, False),
               (2, 96, 128, 32, True), (4, 32, 128, 32, False),
               (4, 96, 16, 64, True), (8, 16, 64, 64, False),
               (1, 96, 128, 64, True)]


@pytest.mark.parametrize("nc,Q,N,P,init", PHASE_SWEEP)
def test_ssd_phases_match_pallas_and_ssd_chunked(nc, Q, N, P, init):
    """The plain version's four phases (cum and C·Bᵀ, chunk states, state
    passing, output) against the Pallas kernel (zero state, y only) and
    the reference model's ``ssd_chunked`` (y and the final state)."""
    H = 3
    x, dt, A, Bm, Cm, D, st = _ssd_inputs(2, nc * Q, H, P, N, seed=nc + Q)
    st = st if init else None
    y, s = ssd_scan_plain(*_torch(x, dt, A, Bm, Cm, D), chunk=Q,
                          init_state=None if st is None
                          else torch.from_numpy(st))
    assert y.shape == (2, nc * Q, H, P) and s.shape == (2, H, P, N)
    y_r, s_r = RS.ssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm[:, :, None], Cm[:, :, None], D)),
        chunk=Q, init_state=None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(y.numpy(), _np(y_r), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(s.numpy(), _np(s_r), atol=2e-4, rtol=2e-3)
    if not init:
        want = pallas_ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), chunk=Q,
                          interpret=True)
        np.testing.assert_allclose(y.numpy(), _np(want), atol=2e-4,
                                   rtol=2e-3)


def test_ssd_phases_shapes_and_state_passing():
    """Each phase's output in the layout the kernels use, and phase 3's
    walk: in_0 is the initial state (as (N, P)), in_{c+1} = exp(cum_last)
    in_c + s_c, the final state the walk past the last chunk."""
    B, nc, Q, H, P, N = 2, 3, 32, 2, 8, 16
    x, dt, A, Bm, Cm, D, st = _torch(*_ssd_inputs(B, nc * Q, H, P, N,
                                                  seed=4))
    cum, CB = SSD.ssd_cum_cb(dt, A, Bm, Cm, Q)
    assert cum.shape == (B, nc, H, Q) and CB.shape == (B, nc, Q, Q)
    torch.testing.assert_close(cum[:, 1, :, -1],
                               (dt[:, Q:2 * Q] * A).sum(1), atol=1e-5,
                               rtol=1e-5)
    s = SSD.ssd_chunk_states(x, dt, Bm, cum)
    assert s.shape == (B, nc, H, N, P)
    ins, final = SSD.ssd_state_passing(s, cum, st)
    assert ins.shape == (B, nc, H, N, P) and final.shape == (B, H, P, N)
    torch.testing.assert_close(ins[:, 0], st.transpose(-1, -2))
    dec = torch.exp(cum[..., -1])
    for c in range(nc - 1):
        torch.testing.assert_close(
            ins[:, c + 1], ins[:, c] * dec[:, c, :, None, None] + s[:, c])
    torch.testing.assert_close(
        final.transpose(-1, -2),
        ins[:, -1] * dec[:, -1, :, None, None] + s[:, -1])
    y = SSD.ssd_chunk_output(x, dt, Cm, D, cum, CB, ins)
    y2, f2 = ssd_scan_plain(x, dt, A, Bm, Cm, D, chunk=Q, init_state=st)
    assert torch.equal(y, y2) and torch.equal(final, f2)


# (B, S, H, P, N, Q, dtype) -> the blocks of phases 1-4 plan_ssd gives:
# mamba2-2.7b at B 1 and 4, S 1024 and 512, in bf16 and f32; its 80 heads
# cut ten ways; zamba2-2.7b's N 64; the chip_smoke sweep and ragged shapes
BF16, F32 = torch.bfloat16, torch.float32
FROZEN_PLANS = {
    (1, 1024, 80, 64, 128, 256, BF16): (120, 640, 320, 1280),
    (1, 1024, 80, 64, 128, 256, F32): (120, 640, 320, 1280),
    (4, 1024, 80, 64, 128, 256, BF16): (480, 2560, 1280, 5120),
    (4, 1024, 80, 64, 128, 256, F32): (480, 2560, 1280, 5120),
    (1, 512, 80, 64, 128, 256, BF16): (60, 320, 320, 640),
    (1, 1024, 8, 64, 128, 256, BF16): (48, 64, 32, 128),
    (1, 1024, 80, 64, 64, 256, BF16): (120, 320, 160, 1280),
    (2, 192, 3, 60, 100, 96, F32): (16, 24, 24, 24),
    (2, 256, 4, 64, 32, 64, F32): (16, 32, 8, 32),
    (2, 128, 2, 32, 16, 32, F32): (16, 16, 4, 16),
    (2, 192, 4, 64, 64, 64, F32): (12, 24, 16, 24),
}


@pytest.mark.parametrize("shape", list(FROZEN_PLANS),
                         ids=lambda k: "x".join(map(str, k[:6]))
                         + "_" + str(k[6]).replace("torch.", ""))
def test_plan_ssd_frozen(shape):
    assert plan_ssd(*shape).blocks == FROZEN_PLANS[shape]


def test_plan_ssd_fills_the_card_and_reads_shapes_only():
    """At mamba2-2.7b's B 1 the two phases with the multiply-adds (2 and
    4) launch at least one block an SM (132), the old kernel's 80 blocks
    did not; the planner is cached on shapes and refuses what the kernels
    do not take."""
    from repro_torch.kernels.matmul import SMS

    for dt in (BF16, F32):
        p = plan_ssd(1, 1024, 80, 64, 128, 256, dt)
        assert p.blocks[1] >= SMS and p.blocks[3] >= SMS
        assert p.blocks[1] + p.blocks[3] > 10 * 80  # the old kernel: 80
    assert plan_ssd(1, 1024, 80, 64, 128, 256, BF16) is \
        plan_ssd(1, 1024, 80, 64, 128, 256, BF16)
    for bad in [(1, 256, 4, 65, 16, 64), (1, 256, 4, 64, 129, 64),
                (1, 250, 4, 64, 16, 64)]:
        with pytest.raises(ValueError):
            plan_ssd(*bad)


@pytest.fixture
def fake_ssd_kernels(monkeypatch):
    """Run ``ssd_scan``'s CUDA branch on CPU tensors against a stand-in
    library that records each C call's arguments (no CUDA here)."""
    import contextlib

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
    yield calls
    ops.reset_launch_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_wrapper_passes_its_scratch(fake_ssd_kernels, dtype, init):
    """``ssd_scan`` hands its kernels f32 scratch for cum (B,nc,H,Q), C·Bᵀ
    (B,nc,Q,Q) and the chunk states (B,nc,H,N,P), the initial state or
    null: one launch counted a call."""
    B, S, H, P, N, Q = 1, 1024, 80, 64, 128, 256
    dt_ = getattr(torch, dtype)
    x = torch.zeros(B, S, H, P, dtype=dt_)
    Bm = torch.zeros(B, S, N, dtype=dt_)
    dt, A, D = torch.zeros(B, S, H), torch.zeros(H), torch.zeros(H)
    st = torch.zeros(B, H, P, N) if init else None
    ops.reset_launch_counts()
    y, final = ops.ssd_scan(x, dt, A, Bm, Bm, D, chunk=Q, init_state=st)
    assert y.shape == x.shape and y.dtype == dt_
    assert final.shape == (B, H, P, N) and final.dtype == torch.float32
    (name, args), = fake_ssd_kernels
    assert name == ("repro_ssd_scan_bf16" if dtype == "bfloat16"
                    else "repro_ssd_scan_f32")
    assert args[:6] == (x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                        Bm.data_ptr(), Bm.data_ptr(), D.data_ptr())
    assert args[6] == (st.data_ptr() if init else None)
    assert args[7:9] == (y.data_ptr(), final.data_ptr())
    assert all(isinstance(a, int) for a in args[9:12])
    assert args[12:] == (B, S, H, P, N, Q, 0)
    assert ops.launch_counts()["ssd_scan"] == 1


# ---------------------------------------------------------------------------
# the mixer's pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = _rng(7)
    x = jnp.asarray(rng.standard_normal((2, 9, 12)), dtype)
    w = jnp.asarray(rng.standard_normal((4, 12)) * 0.5, dtype)
    st = jnp.asarray(rng.standard_normal((2, 3, 12)), dtype) if with_state \
        else None
    y_r, s_r = RS.causal_conv(x, w, st)
    y, s = SM.causal_conv(_t(x), _t(w), None if st is None else _t(st))
    assert y.dtype == _t(x).dtype
    np.testing.assert_array_equal(_np(y.float()), _np(y_r))
    np.testing.assert_array_equal(_np(s.float()), _np(s_r))


def test_ssd_decode_step_matches_reference():
    rng = _rng(8)
    B, H, P, N = 2, 3, 8, 4
    x = rng.standard_normal((B, H, P)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, H))).astype(np.float32) * 0.3
    A = -np.linspace(0.5, 2.0, H).astype(np.float32)
    Bm = rng.standard_normal((B, 1, N)).astype(np.float32)
    Cm = rng.standard_normal((B, 1, N)).astype(np.float32)
    D = np.ones((H,), np.float32)
    st = rng.standard_normal((B, H, P, N)).astype(np.float32)
    y_r, s_r = RS.ssd_decode_step(*map(jnp.asarray, (x, dt, A, Bm, Cm, D,
                                                     st)))
    y, s = SM.ssd_decode_step(*_torch(x, dt, A, Bm, Cm, D, st))
    np.testing.assert_allclose(y.numpy(), _np(y_r), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.numpy(), _np(s_r), atol=1e-5, rtol=1e-5)


def test_ssd_decode_continues_the_chunked_scan():
    """The chunked scan over S tokens equals the scan over S-16 and then 16
    recurrent steps (the twin of the reference's
    ``test_ssd_decode_continues_sequence``)."""
    x, dt, A, Bm, Cm, D, _ = _torch(*_ssd_inputs(1, 64, 2, 8, 4, seed=9))
    y_full, _ = SM.ssd_chunked(x, dt, A, Bm[:, :, None], Cm[:, :, None], D,
                               chunk=16)
    _, st = SM.ssd_chunked(x[:, :48], dt[:, :48], A, Bm[:, :48, None],
                           Cm[:, :48, None], D, chunk=16)
    ys = []
    for t in range(48, 64):
        y1, st = SM.ssd_decode_step(x[:, t], dt[:, t], A, Bm[:, t, None],
                                    Cm[:, t, None], D, st)
        ys.append(y1)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               y_full[:, 48:].numpy(), atol=2e-4, rtol=2e-3)


def _mixer(dtype, seed=0):
    rcfg = ref_get_config(ARCH).reduced(dtype=dtype, ssm_chunk=8)
    cfg = get_config(ARCH).reduced(dtype=dtype, ssm_chunk=8)
    rp = RS.mamba_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, rp, _from_ref(rp)


def _close(got, want, dtype):
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(got.float()), _np(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_seq_matches_reference(dtype):
    """From zero states, then continuing from the states it returned."""
    rcfg, cfg, rp, pp = _mixer(dtype)
    rng = _rng(10)
    xs = [jnp.asarray(rng.standard_normal((2, 16, rcfg.d_model)), dtype)
          for _ in range(2)]
    y_r, (c_r, s_r) = RS.mamba_apply_seq(rp, xs[0], rcfg)
    y, (c, s) = SM.mamba_apply_seq(pp, _t(xs[0]), cfg)
    _close(y, y_r, dtype)
    _close(s, s_r, dtype)
    y_r, (c_r, s_r) = RS.mamba_apply_seq(rp, xs[1], rcfg, c_r, s_r)
    y, (c, s) = SM.mamba_apply_seq(pp, _t(xs[1]), cfg, c, s)
    _close(y, y_r, dtype)
    _close(s, s_r, dtype)
    for a, b in zip(c, c_r):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode_step_matches_reference(dtype):
    rcfg, cfg, rp, pp = _mixer(dtype, seed=1)
    rst = RS.mamba_state_init(rcfg, 2, jnp.dtype(dtype))
    st = SM.mamba_state_init(cfg, 2, getattr(torch, dtype), device="cpu")
    for k in rst:
        assert tuple(st[k].shape) == rst[k].shape
        assert bf16.dtype_name(st[k].dtype) == str(rst[k].dtype)
    rc = (rst["conv_x"], rst["conv_B"], rst["conv_C"])
    c = (st["conv_x"], st["conv_B"], st["conv_C"])
    rs, s = rst["ssm"], st["ssm"]
    rng = _rng(11)
    for _ in range(5):
        x = jnp.asarray(rng.standard_normal((2, 1, rcfg.d_model)), dtype)
        y_r, (rc, rs) = RS.mamba_decode_step(rp, x, rcfg, rc, rs)
        y, (c, s) = SM.mamba_decode_step(pp, _t(x), cfg, c, s)
        _close(y, y_r, dtype)
        _close(s, rs, dtype)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
def _cfgs(dtype):
    return (ref_get_config(ARCH).reduced(dtype=dtype, ssm_chunk=8),
            get_config(ARCH).reduced(dtype=dtype, ssm_chunk=8))


def test_init_params_tree_matches_reference():
    rcfg, cfg = _cfgs("bfloat16")
    want = jax.eval_shape(lambda k: RT.init_params(k, rcfg),
                          jax.random.PRNGKey(0))
    got = T.init_params(cfg, torch.Generator().manual_seed(0))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        assert bf16.dtype_name(g.dtype) == str(w.dtype), path
    # the reference's fixed values where it draws none (A_log to 1e-6:
    # torch's and jnp's linspace and log round differently)
    ref = RT.init_params(jax.random.PRNGKey(0), rcfg)["blocks"]["mamba"]
    for k in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(got["blocks"]["mamba"][k].numpy(),
                                   _np(ref[k]), rtol=1e-6, atol=0)


def _tol(dtype):
    return dict(atol=1e-4, rtol=1e-4) if dtype == "float32" \
        else dict(atol=0.1, rtol=0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    rcfg, cfg = _cfgs(dtype)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    toks = _rng(3, 16).integers(0, cfg.vocab_size, size=(2, 16)).astype(
        np.int32)
    rl, raux, _ = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rcfg)
    pl, paux, _ = T.forward(pp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert pl.shape == (2, 16, cfg.vocab_size) and pl.dtype == torch.float32
    assert float(paux) == float(raux) == 0.0
    np.testing.assert_allclose(pl.numpy(), _np(rl), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    rcfg, cfg = _cfgs(dtype)
    rp = RT.init_params(jax.random.PRNGKey(1), rcfg)
    pp = _from_ref(rp)
    B, S = 2, 12
    toks = _rng(S, B).integers(0, cfg.vocab_size, size=(B, S)).astype(
        np.int32)
    rstate = RT.init_decode_state(rcfg, B, S)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    assert sorted(state) == sorted(rstate)
    for k in rstate:
        assert tuple(state[k].shape) == rstate[k].shape
        assert bf16.dtype_name(state[k].dtype) == str(rstate[k].dtype)
    rstep = jax.jit(lambda p, s, b, pos: RT.decode_step(p, s, b, pos, rcfg))
    for t in range(S):
        rl, rstate = rstep(rp, rstate,
                           {"tokens": jnp.asarray(toks[:, t:t + 1])},
                           jnp.int32(t))
        lg, state = T.decode_step(
            pp, state, {"tokens": torch.from_numpy(toks[:, t:t + 1])}, t, cfg)
        assert lg.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(lg.numpy(), _np(rl), **_tol(dtype))
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(state["ssm"].numpy(), _np(rstate["ssm"]),
                               atol=tol, rtol=tol)


def test_decode_matches_own_forward():
    """The twin of the reference's ``test_decode_matches_forward`` for
    mamba2 (bf16, the port's own weights, chunk 8 over 16 tokens)."""
    _, cfg = _cfgs("bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    B, S = 2, 16
    toks = torch.from_numpy(_rng(16, 8).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int64))
    logits, _, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, state = T.decode_step(params, state,
                                  {"tokens": toks[:, t:t + 1]}, t, cfg)
        outs.append(lg[:, 0])
    assert float((torch.stack(outs, dim=1) - logits).abs().max()) < 0.08


@pytest.mark.parametrize("fn", ["init_decode_state", "mamba_state_init"])
def test_decode_state_defaults_to_the_card(fn):
    """``init_decode_state`` and ``mamba_state_init`` default to "cuda",
    the port's rule for entry points, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default does not raise")
    cfg = get_config(ARCH).reduced()
    with pytest.raises(RuntimeError):
        if fn == "init_decode_state":
            T.init_decode_state(cfg, 1, 8)
        else:
            SM.mamba_state_init(cfg, 1, torch.float32)
