"""The port's kernels (repro_torch.kernels) against the JAX package's Pallas
kernels, run as the reference's own tests run them on the CPU
(``interpret=True``), over the reference sweeps of tests/test_kernels.py.

On a CPU tensor each wrapper takes its plain PyTorch version, so these
tests hold the plain versions (and the wrappers' shape/padding handling)
to the Pallas kernels; the CUDA kernels themselves are held to the same
plain versions on the card by chip_smoke.py.

Tolerance: f32, rtol=1e-4 and atol=5e-4*sqrt(K) — the two sides sum K
products in different orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.registry import LayerSpec as RefLayerSpec
from repro.core.registry import LinearPacked as RefLinearPacked
from repro.kernels import ref as R
from repro.kernels.conv_winograd import winograd_tile_matmul as pallas_wino
from repro.kernels.matmul import matmul as pallas_matmul
from repro.kernels.matmul import matmul_packed as pallas_matmul_packed
from repro_torch.core.registry import LayerSpec, LinearPacked
from repro_torch.kernels import _native, ops
from repro_torch.kernels.conv_winograd import winograd_tile_matmul_plain
from repro_torch.kernels.matmul import matmul_packed_plain, matmul_plain

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


def _rng(*key):
    return np.random.default_rng(list(key))


def _close(got, want, K):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=1e-4, atol=5e-4 * np.sqrt(K))


@pytest.fixture(autouse=True)
def _zero_counts():
    ops.reset_launch_counts()
    yield
    # a CPU tensor never launches a CUDA kernel
    assert all(n == 0 for n in ops.launch_counts().values())


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (200, 300, 150),
                                   (64, 512, 96), (1, 128, 128)])
def test_matmul_matches_pallas(M, K, N):
    rng = _rng(1, M, K, N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    want = pallas_matmul(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (M, N) and got.dtype == torch.float32
    _close(got.numpy(), want, K)
    _close(matmul_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
           R.matmul_ref(jnp.asarray(x), jnp.asarray(w)), K)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (200, 300, 150),
                                   (64, 512, 96), (1, 128, 128)])
def test_matmul_bf16_matches_pallas(M, K, N):
    """bf16 in and out, f32 accumulate: the reference sweep's bf16 arm at
    its tolerance (5e-2, atol scaled by sqrt(K))."""
    from repro_torch import bf16

    rng = _rng(4, M, K, N)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((K, N)), jnp.bfloat16)
    want = pallas_matmul(x, w, interpret=True)
    tx, tw = (bf16.to_tensor(np.array(np.asarray(a))) for a in (x, w))
    got = ops.matmul(tx, tw)
    assert got.shape == (M, N) and got.dtype == torch.bfloat16
    for out in (got, matmul_plain(tx, tw)):
        np.testing.assert_allclose(
            out.to(torch.float32).numpy(), np.asarray(want, np.float32),
            atol=5e-2 * np.sqrt(K), rtol=5e-2)
    assert ops.launch_counts()["matmul_bf16"] == 0


@pytest.mark.parametrize("K,N", [(300, 150), (128, 128), (100, 37)])
def test_matmul_packed_matches_pallas(K, N):
    rng = _rng(2, K, N)
    x = rng.standard_normal((64, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    spec = LayerSpec("l", "linear", {"in_features": K, "out_features": N},
                     {"w": (K, N)})
    packed = LinearPacked().transform({"w": w}, spec)["w_packed"]
    ref_packed = RefLinearPacked().transform(
        {"w": w}, RefLayerSpec("l", "linear",
                               {"in_features": K, "out_features": N},
                               {"w": (K, N)}))["w_packed"]
    assert packed.tobytes() == ref_packed.tobytes()
    want = pallas_matmul_packed(jnp.asarray(x), jnp.asarray(packed), K, N,
                                interpret=True)
    got = ops.matmul_packed(torch.from_numpy(x), torch.from_numpy(packed),
                            K, N)
    assert got.shape == (64, N)
    _close(got.numpy(), want, K)
    # the K padding of the Pallas wrapper: a padded x gives the same result
    xp = np.pad(x, ((0, 0), (0, packed.shape[1] * 128 - K)))
    _close(matmul_packed_plain(torch.from_numpy(xp), torch.from_numpy(packed),
                               K, N).numpy(), want, K)


@pytest.mark.parametrize("M,K,N", [(64, 300, 150), (1, 256, 100),
                                   (3, 129, 7)])
def test_matmul_packed_bf16_x_matches_pallas(M, K, N):
    """A bf16 x against the Pallas kernel on the same ``LinearPacked``
    bytes: the output is bf16, as ``_mm_packed_kernel`` writes x's dtype,
    within the bf16 arm's tolerance (5e-2, atol scaled by sqrt(K))."""
    from repro_torch import bf16

    rng = _rng(5, M, K, N)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    w = rng.standard_normal((K, N)).astype(np.float32)
    spec = LayerSpec("l", "linear", {"in_features": K, "out_features": N},
                     {"w": (K, N)})
    packed = LinearPacked().transform({"w": w}, spec)["w_packed"]
    want = pallas_matmul_packed(x, jnp.asarray(packed), K, N, interpret=True)
    assert want.dtype == jnp.bfloat16
    tx = bf16.to_tensor(np.array(np.asarray(x)))
    for got in (ops.matmul_packed(tx, torch.from_numpy(packed), K, N),
                matmul_packed_plain(tx, torch.from_numpy(packed), K, N)):
        assert got.shape == (M, N) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(
            got.to(torch.float32).numpy(), np.asarray(want, np.float32),
            atol=5e-2 * np.sqrt(K), rtol=5e-2)


@pytest.mark.parametrize("T,C,O", [(200, 48, 72), (128, 128, 64),
                                   (60, 17, 9), (300, 3, 64), (257, 64, 64)])
def test_winograd_tile_matmul_matches_pallas(T, C, O):
    rng = _rng(3, T, C, O)
    V = rng.standard_normal((16, T, C)).astype(np.float32)
    U = rng.standard_normal((16, C, O)).astype(np.float32)
    want = pallas_wino(jnp.asarray(V), jnp.asarray(U), bt=64, bc=64,
                       interpret=True)
    got = ops.winograd_tile_matmul(torch.from_numpy(V), torch.from_numpy(U))
    assert got.shape == (16, T, O)
    _close(got.numpy(), want, C)
    _close(winograd_tile_matmul_plain(torch.from_numpy(V),
                                      torch.from_numpy(U)).numpy(),
           R.winograd_tile_matmul_ref(jnp.asarray(V), jnp.asarray(U)), C)


def test_wrappers_reject_bad_shapes_and_devices():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.matmul(x, torch.zeros(7, 3))
    with pytest.raises(ValueError):
        ops.winograd_tile_matmul(torch.zeros(16, 4, 8), torch.zeros(16, 7, 3))
    with pytest.raises(ValueError):
        ops.matmul_packed(x, torch.zeros(1, 1, 128, 128), K=9, N=3)
    # split across devices (meta, the dry run's, beside the CPU): no plain
    # fallback, no launch
    with pytest.raises(ValueError):
        ops.matmul(x.to("meta"), torch.zeros(8, 3))


def test_packed_and_int4_wrappers_reject_bad_shapes_and_devices():
    """``matmul_packed`` and ``matmul_dequant_int4`` check their shapes
    before any dispatch, and refuse tensors split across devices (no
    plain fallback, no launch)."""
    xb = torch.zeros(4, 300, dtype=torch.bfloat16)
    wp = torch.zeros(2, 3, 128, 128)
    with pytest.raises(ValueError):          # K beyond the panels' rows
        ops.matmul_packed(torch.zeros(4, 400), wp, K=400, N=150)
    with pytest.raises(ValueError):          # N beyond the panels' columns
        ops.matmul_packed(xb, wp, K=300, N=257)
    with pytest.raises(ValueError):          # x's K is not K
        ops.matmul_packed(xb, wp, K=299, N=150)
    with pytest.raises(ValueError):          # w_packed not 4-d
        ops.matmul_packed(xb, wp[0], K=300, N=150)
    with pytest.raises(ValueError):          # mixed devices
        ops.matmul_packed(xb, wp.to("meta"), K=300, N=150)
    p4 = torch.zeros(65, 7, dtype=torch.uint8)
    s = torch.ones(1, 7)
    with pytest.raises(ValueError):          # packed rows hold K = 129, 130
        ops.matmul_dequant_int4(torch.zeros(3, 128), p4, s, K=128)
    with pytest.raises(ValueError):          # x's K is not K
        ops.matmul_dequant_int4(torch.zeros(3, 130), p4, s, K=129)
    with pytest.raises(ValueError):          # scale is not (1, N)
        ops.matmul_dequant_int4(torch.zeros(3, 129), p4, torch.ones(1, 8),
                                K=129)
    with pytest.raises(ValueError):          # mixed devices
        ops.matmul_dequant_int4(torch.zeros(3, 129, dtype=torch.bfloat16),
                                p4.to("meta"), s, K=129)


def test_native_build_is_named_by_source_digest(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    for name in _native.SOURCES:
        p = _native.library_path(name)
        assert p.parent == tmp_path
        assert p.name.startswith(f"lib{name}_") and p.suffix == ".so"
        assert (_native.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
    with pytest.raises(RuntimeError):
        _native.check(1, "matmul")


# ---------------------------------------------------------------------------
# the bf16 template: a K-major w read in place, and the host planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(4, 96, 200), (64, 128, 37),
                                   (4, 1536, 40)])
def test_matmul_kmajor_w_matches_pallas(M, K, N, dtype):
    """A w whose .T is contiguous (the tied head's embed.T) against the
    Pallas matmul on the contiguous copy, at each dtype's tolerance."""
    from repro_torch import bf16

    rng = _rng(5, M, K, N)
    x = jnp.asarray(rng.standard_normal((M, K)), dtype)
    emb = jnp.asarray(rng.standard_normal((N, K)), dtype)   # (V, d)
    want = pallas_matmul(x, jnp.asarray(np.asarray(emb).T.copy()),
                         interpret=True)
    tx, temb = (bf16.to_tensor(np.array(np.asarray(a))) for a in (x, emb))
    w = temb.T
    assert w.stride() == (1, K) and not w.is_contiguous()
    got = ops.matmul(tx, w)
    assert got.shape == (M, N) and got.dtype == tx.dtype
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32),
                               atol=tol * np.sqrt(K), rtol=tol)


def test_mm_passes_kmajor_w_without_a_copy(monkeypatch):
    """``layers._mm`` hands a K-major w to ``ops.matmul`` as it is (stride
    (1, K), the embedding's own storage); any other strided w is copied."""
    from repro_torch.models import layers as L

    seen = []

    def spy(x, w, out_dtype=None):
        seen.append(w)
        return matmul_plain(x, w, out_dtype)

    monkeypatch.setattr(ops, "matmul", spy)
    emb = torch.randn(50, 8, dtype=torch.bfloat16)
    x = torch.randn(2, 3, 8, dtype=torch.bfloat16)
    y = L._mm(x, emb.T)
    assert y.shape == (2, 3, 50)
    assert seen[-1].stride() == (1, 8)
    assert seen[-1].data_ptr() == emb.data_ptr()
    strided = torch.randn(8, 100)[:, ::2]          # neither layout
    L._mm(x.float(), strided)
    assert seen[-1].is_contiguous()


def test_tied_head_reads_embed_in_place(monkeypatch):
    """The tied LM head of ``transformer._lm_logits`` reads ``embed``
    itself: no ``.contiguous()`` copy of ``embed.T`` on the path."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("smollm-360m").reduced()
    assert cfg.tie_embeddings
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    seen = []

    def spy(x, w, out_dtype=None):
        seen.append(w)
        return matmul_plain(x, w, out_dtype)

    monkeypatch.setattr(ops, "matmul", spy)
    h = torch.randn(1, 3, cfg.d_model).to(params["embed"].dtype)
    logits = T._lm_logits(params, cfg, h)
    assert logits.shape == (1, 3, cfg.vocab_size)
    w = seen[-1]
    assert w.data_ptr() == params["embed"].data_ptr()
    assert w.stride() == (1, cfg.d_model)


def test_matmul_refuses_kmajor_w_off_cpu_and_cuda():
    # a K-major w on another device than x (meta, the dry run's, beside
    # the CPU): no fallback
    with pytest.raises(ValueError):
        ops.matmul(torch.zeros(4, 8, device="meta"), torch.zeros(3, 8).T)


# (M, K, N, batch): every matmul_bf16 and gmm_blocks bf16 row of
# chip_smoke.py, with the path the planner must pick
PLANNER_ROWS = [
    ((64, 960, 960, 1), "tile"), ((64, 960, 2560, 1), "tile"),
    ((64, 2560, 960, 1), "tile"), ((64, 960, 49152, 1), "tile"),
    ((1, 960, 960, 1), "skinny"), ((1, 960, 2560, 1), "skinny"),
    ((1, 2560, 960, 1), "skinny"), ((1, 960, 49152, 1), "skinny"),
    ((4, 960, 960, 1), "skinny"), ((4, 960, 2560, 1), "skinny"),
    ((4, 2560, 960, 1), "skinny"), ((4, 960, 49152, 1), "skinny"),
    ((1, 1536, 1536, 1), "skinny"), ((1, 1536, 512, 1), "skinny"),
    ((1, 1536, 49155, 1), "skinny"), ((4, 1536, 1536, 1), "skinny"),
    ((4, 1536, 512, 1), "skinny"), ((4, 1536, 49155, 1), "skinny"),
    ((512, 1536, 1536, 1), "tile"), ((512, 1536, 512, 1), "tile"),
    ((512, 1536, 49155, 1), "tile"), ((1024, 2560, 128, 1), "tile"),
    ((1024, 2560, 80, 1), "tile"), ((1024, 5120, 2560, 1), "tile"),
    ((1024, 2560, 50280, 1), "tile"),
    ((1024, 2560, 5120, 1), "tile"), ((4, 2560, 5120, 1), "skinny"),
    ((4, 5120, 2560, 1), "skinny"), ((4, 2560, 50280, 1), "skinny"),
    ((3, 129, 7, 1), "skinny"), ((100, 200, 49155, 1), "tile"),
    ((20, 37, 50, 1), "tile"), ((5, 1536, 49155, 1), "skinny"),
    ((1, 256, 100, 1), "skinny"),
    # the archs path's rows: qwen3-32b's prefill, gemma2-27b's 4608 tokens
    ((512, 5120, 8192, 1), "tile"), ((512, 5120, 25600, 1), "tile"),
    ((512, 5120, 151936, 1), "tile"), ((4608, 4608, 36864, 1), "tile"),
    ((4608, 4608, 256000, 1), "tile"),
    ((8, 1536, 512, 40), "skinny"), ((8, 512, 1536, 40), "skinny"),
    ((208, 1536, 512, 40), "tile"), ((64, 32, 48, 4), "tile"),
    ((128, 128, 128, 8), "tile"), ((40, 20, 9, 3), "tile"),
    # qwen3-moe-30b-a3b's expert blocks: decode C 8, a prefill's C 64
    ((8, 2048, 768, 128), "skinny"), ((8, 768, 2048, 128), "skinny"),
    ((64, 2048, 768, 128), "tile"), ((64, 768, 2048, 128), "tile")]


@pytest.mark.parametrize("shape,path", PLANNER_ROWS,
                         ids=["x".join(map(str, s)) for s, _ in PLANNER_ROWS])
def test_plan_bf16_gemm(shape, path):
    from repro_torch.kernels.matmul import SMS, plan_bf16_gemm

    M, K, N, batch = shape
    p = plan_bf16_gemm(M, N, K, batch)
    assert p.path == path
    assert p.bm == (16 if path == "skinny" else p.bm) and p.bm in (16, 64, 128)
    assert p.bn == (64 if path == "skinny" else 128)
    assert p.ksteps == -(-K // 64) and p.ksteps % p.split == 0
    tiles = batch * -(-M // p.bm) * -(-N // p.bn)
    assert p.blocks == tiles * p.split
    if tiles >= SMS:
        assert p.split == 1
    elif p.split > 1:
        # the smallest divisor that fills the card, or, where none does,
        # one K step a block
        fills = [d for d in range(2, p.ksteps + 1)
                 if p.ksteps % d == 0 and tiles * d >= SMS]
        assert p.split == (fills[0] if fills else p.ksteps)
        assert p.blocks >= SMS or p.split == p.ksteps


def test_plan_bf16_gemm_decisions():
    """The decisions the design rests on: 128-row tiles for mamba2's
    prefill projection, the LM head unsplit, decode projections split to
    fill the card, granite's decode expert blocks on the skinny path."""
    from repro_torch.kernels.matmul import SMS, plan_bf16_gemm

    assert plan_bf16_gemm(1024, 5120, 2560).bm == 128
    # the prefill tied heads: 128-row tiles (read K-major), unsplit
    for M, N, K in [(512, 49155, 1536), (1024, 50280, 2560)]:
        p = plan_bf16_gemm(M, N, K)
        assert (p.path, p.bm, p.split) == ("tile", 128, 1)
    assert plan_bf16_gemm(64, 49152, 960).split == 1
    p = plan_bf16_gemm(4, 5120, 2560)
    assert p.split == 2 and p.blocks >= SMS
    p = plan_bf16_gemm(8, 512, 1536, 40)
    assert (p.path, p.split, p.blocks) == ("skinny", 1, 320)
    assert plan_bf16_gemm(2, 5, 0).split == 1          # K = 0: no K steps


# ---------------------------------------------------------------------------
# the f32 template's host planner, and what the f32 and decode wrappers pass
# their kernels
# ---------------------------------------------------------------------------
# (M, K, N, K-major w): every f32 matmul row of chip_smoke.py
F32_PLANNER_ROWS = [
    ((12544, 576, 128, False), "tile"), ((3136, 1152, 256, False), "tile"),
    ((1, 256, 100, False), "skinny"), ((1, 1536, 40, False), "skinny"),
    ((4, 1536, 40, False), "skinny"), ((512, 1536, 40, False), "tile"),
    ((1, 2560, 5120, False), "skinny"), ((1, 2560, 128, False), "skinny"),
    ((1, 2560, 80, False), "skinny"), ((1, 5120, 2560, False), "skinny"),
    ((1, 2560, 50280, True), "skinny"), ((1024, 2560, 50280, True), "tile"),
    ((1024, 2560, 5120, False), "tile"), ((3, 129, 7, False), "skinny"),
    ((100, 200, 4099, False), "tile"), ((20, 37, 50, True), "tile"),
    ((5, 37, 50, True), "skinny"), ((4, 1536, 40, False), "skinny"),
    ((64, 576, 128, False), "tile"), ((16, 2560, 50280, True), "skinny"),
    # matmul_packed's and matmul_dequant_int4's rows (the f32 matmul's
    # yardstick of the first)
    ((64, 960, 2560, False), "tile"), ((64, 300, 150, False), "tile"),
    ((3, 300, 150, False), "skinny"), ((1, 960, 2560, False), "skinny"),
    ((8, 960, 2560, False), "skinny"), ((64, 129, 100, False), "tile"),
    ((20, 37, 7, False), "tile")]


@pytest.mark.parametrize("shape,path", F32_PLANNER_ROWS,
                         ids=["x".join(map(str, s)) for s, _ in
                              F32_PLANNER_ROWS])
def test_plan_f32_gemm(shape, path):
    from repro_torch.kernels.matmul import (F32_SKINNY_COLS,
                                            F32_SKINNY_MIN_STEPS, F32_TILE_BM,
                                            F32_TILE_BN, F32_X_FLOATS, SMS,
                                            plan_f32_gemm)

    M, K, N, kmajor = shape
    p = plan_f32_gemm(M, N, K, kmajor)
    assert p.path == path
    assert p.ksteps == -(-K // 16) and p.ksteps % p.split == 0
    if path == "skinny":
        assert p.bn == F32_SKINNY_COLS[kmajor]
        # the x slice of a split fits the block's shared memory
        assert p.ksteps // p.split * 16 * M <= F32_X_FLOATS
        tiles = -(-N // p.bn)
    else:
        assert p.bm in F32_TILE_BM and p.bn in F32_TILE_BN
        assert p.bn == 64 or N > 64
        tiles = -(-M // p.bm) * -(-N // p.bn)
        # K is split only where the output tiles alone leave SMs idle
        assert p.split == 1 or tiles < SMS
    assert p.blocks == tiles * p.split
    if path == "skinny":
        # a split takes at least F32_SKINNY_MIN_STEPS K steps where K has
        # them; the blocks fill the card, or no longer split keeps that many
        least = min(F32_SKINNY_MIN_STEPS, p.ksteps)
        assert p.ksteps // p.split >= least
        more = [d for d in range(p.split + 1, p.ksteps + 1)
                if p.ksteps % d == 0 and p.ksteps // d >= least]
        assert p.blocks >= SMS or not more
    else:
        # blocks fill the card, or K is split one step a split
        assert p.blocks >= SMS or p.split == p.ksteps


def test_plan_f32_gemm_decisions():
    """The decisions the design rests on: resnet50's im2col GEMMs in two
    blocks an SM; granite's router at decode split to four K steps a
    block; mamba2's tied head read K-major on the skinny path."""
    from repro_torch.kernels.matmul import plan_f32_gemm

    # 262 tiles of 96 x 64 unsplit, two blocks an SM
    p = plan_f32_gemm(12544, 128, 576)
    assert (p.path, p.bm, p.bn, p.split, p.blocks) == ("tile", 96, 64, 1,
                                                       262)
    p = plan_f32_gemm(3136, 256, 1152)
    assert (p.path, p.bm, p.bn, p.split, p.blocks) == ("tile", 96, 128, 4,
                                                       264)
    assert plan_f32_gemm(1, 40, 1536).split == 24
    p = plan_f32_gemm(1, 50280, 2560, True)
    assert (p.path, p.bn, p.split) == ("skinny", 32, 1)
    assert plan_f32_gemm(2, 5, 0).split == 1          # K = 0: no K steps


# every batch-1 plan of the f32 template as it was before the batched paths
# came in: (M, K, N, K-major w) -> (path, bm, bn, split, ksteps, blocks)
F32_BATCH1_PLANS = [
    ((12544, 576, 128, False), ("tile", 96, 64, 1, 36, 262)),
    ((3136, 1152, 256, False), ("tile", 96, 128, 4, 72, 264)),
    ((1, 256, 100, False), ("skinny", 16, 128, 4, 16, 4)),
    ((1, 1536, 40, False), ("skinny", 16, 128, 24, 96, 24)),
    ((4, 1536, 40, False), ("skinny", 16, 128, 24, 96, 24)),
    ((512, 1536, 40, False), ("tile", 64, 64, 32, 96, 256)),
    ((1, 2560, 5120, False), ("skinny", 16, 128, 4, 160, 160)),
    ((1, 2560, 128, False), ("skinny", 16, 128, 40, 160, 40)),
    ((1, 2560, 80, False), ("skinny", 16, 128, 40, 160, 40)),
    ((1, 5120, 2560, False), ("skinny", 16, 128, 8, 320, 160)),
    ((1, 2560, 50280, True), ("skinny", 16, 32, 1, 160, 1572)),
    ((1024, 2560, 50280, True), ("tile", 128, 128, 1, 160, 3144)),
    ((1024, 2560, 5120, False), ("tile", 128, 64, 1, 160, 640)),
    ((3, 129, 7, False), ("skinny", 16, 128, 1, 9, 1)),
    ((100, 200, 4099, False), ("tile", 64, 64, 13, 13, 1690)),
    ((20, 37, 50, True), ("tile", 64, 64, 3, 3, 3)),
    ((5, 37, 50, True), ("skinny", 16, 32, 1, 3, 2)),
    ((64, 576, 128, False), ("tile", 64, 64, 36, 36, 72)),
    ((16, 2560, 50280, True), ("skinny", 16, 32, 4, 160, 6288)),
    ((2, 0, 5, False), ("skinny", 16, 128, 1, 0, 1)),
    # the Winograd stage shapes as single GEMMs
    ((12544, 64, 64, False), ("tile", 96, 64, 2, 4, 262)),
    ((300, 100, 33, False), ("tile", 64, 64, 7, 7, 35)),
    ((257, 64, 64, False), ("tile", 64, 64, 4, 4, 20)),
    # matmul_packed's and matmul_dequant_int4's rows: the tblock up
    # projection (the yardstick's shape), ragged tiles, decode at M 1 and 8
    ((64, 960, 2560, False), ("tile", 64, 64, 60, 60, 2400)),
    ((64, 300, 150, False), ("tile", 64, 64, 19, 19, 57)),
    ((3, 300, 150, False), ("skinny", 16, 128, 1, 19, 2)),
    ((1, 960, 2560, False), ("skinny", 16, 128, 10, 60, 200)),
    ((8, 960, 2560, False), ("skinny", 16, 128, 10, 60, 200)),
    ((64, 129, 100, False), ("tile", 64, 64, 9, 9, 18)),
    ((20, 37, 7, False), ("tile", 64, 64, 3, 3, 3))]


@pytest.mark.parametrize("shape,plan", F32_BATCH1_PLANS,
                         ids=["x".join(map(str, s)) for s, _ in
                              F32_BATCH1_PLANS])
def test_plan_f32_gemm_batch1_unchanged(shape, plan):
    """``batch=1`` (the default, and given) plans every f32 GEMM as before
    the batched paths: matmul's f32 entry keeps its behaviour."""
    from repro_torch.kernels.matmul import plan_f32_gemm

    M, K, N, kmajor = shape
    assert tuple(plan_f32_gemm(M, N, K, kmajor)) == plan
    assert tuple(plan_f32_gemm(M, N, K, kmajor, 1)) == plan


# resnet50@224's 3x3/s1 stages as Winograd's 16 GEMMs (T, C, O), with the
# path and tile plan_f32_gemm(T, O, C, batch=16) gives them
WINO_PLANS = [((12544, 3, 64), ("stream", 128, 64)),
              ((12544, 64, 64), ("stream", 128, 64)),
              ((3136, 128, 128), ("tile", 96, 128)),
              ((784, 256, 256), ("tile", 128, 128)),
              ((300, 5, 70), ("stream", 128, 64)),
              ((257, 100, 33), ("tile", 96, 64))]


@pytest.mark.parametrize("shape,want", WINO_PLANS,
                         ids=["x".join(map(str, s)) for s, _ in WINO_PLANS])
def test_plan_f32_gemm_batched(shape, want):
    """Short K (<= F32_STREAM_MAX_K) streams: persistent blocks, two an SM
    at most, over (16 x row tiles x column tiles) items; longer K runs the
    batched tile path over 16 x tiles, K split only where those leave SMs
    idle."""
    from repro_torch.kernels.matmul import (F32_STREAM_MAX_K,
                                            F32_STREAM_PER_SM, SMS,
                                            plan_f32_gemm)

    T, C, O = shape
    p = plan_f32_gemm(T, O, C, False, 16)
    assert (p.path, p.bm, p.bn) == want
    assert p.ksteps == -(-C // 16)
    tiles = 16 * -(-T // p.bm) * -(-O // p.bn)
    if p.path == "stream":
        assert C <= F32_STREAM_MAX_K and p.split == 1
        assert p.blocks == min(tiles, F32_STREAM_PER_SM * SMS)
    else:
        assert C > F32_STREAM_MAX_K
        assert p.blocks == tiles * p.split
        assert p.split == 1 or tiles < SMS
    assert plan_f32_gemm(T, O, C, False, 16) is p   # cached, shapes only


# (M, K, N, batch) -> (path, bn, split, blocks): the batched skinny path
# at M <= 16 with row limits (gmm_blocks at decode, the expert on
# blockIdx.z), one 128-column block per entry and column slab, split as at
# batch 1 but over batch x column blocks
BATCHED_SKINNY_PLANS = [
    ((8, 1536, 512, 40), ("skinny", 128, 1, 160)),
    ((8, 512, 1536, 40), ("skinny", 128, 1, 480)),
    ((1, 1536, 512, 40), ("skinny", 128, 1, 160)),
    ((16, 300, 100, 16), ("skinny", 128, 1, 16)),
    ((4, 1536, 40, 3), ("skinny", 128, 24, 72)),
    ((16, 2560, 512, 2), ("skinny", 128, 20, 160))]


@pytest.mark.parametrize("shape,want", BATCHED_SKINNY_PLANS,
                         ids=["x".join(map(str, s))
                              for s, _ in BATCHED_SKINNY_PLANS])
def test_plan_f32_gemm_batched_skinny(shape, want):
    """M <= 16 in a batch with row limits (``row_limit=True``, gmm's plan)
    takes the skinny path; the x slice of a split fits the block's shared
    memory, the split keeps the skinny rule over batch x column blocks.
    Without row limits such a batch plans as before: the stream path where
    K <= 64, else the tile path."""
    from repro_torch.kernels.matmul import (F32_SKINNY_MIN_STEPS,
                                            F32_X_FLOATS, SMS,
                                            plan_f32_gemm)

    M, K, N, batch = shape
    p = plan_f32_gemm(M, N, K, False, batch, True)
    assert (p.path, p.bn, p.split, p.blocks) == want
    assert plan_f32_gemm(M, N, K, False, batch).path == (
        "stream" if K <= 64 else "tile")
    assert p.ksteps // p.split * 16 * M <= F32_X_FLOATS
    assert p.blocks == batch * -(-N // 128) * p.split
    least = min(F32_SKINNY_MIN_STEPS, p.ksteps)
    assert p.ksteps // p.split >= least
    # the blocks fill the card, or no longer split keeps that many steps
    more = [d for d in range(p.split + 1, p.ksteps + 1)
            if p.ksteps % d == 0 and p.ksteps // d >= least]
    assert p.blocks >= SMS or not more


@pytest.fixture
def fake_kernels(monkeypatch):
    """Run a wrapper's CUDA branch on CPU tensors against a stand-in
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


def test_mm_passes_f32_kmajor_w_to_the_kernel_uncopied(fake_kernels):
    """``layers._mm`` with an f32 ``embed.T`` (mamba2's tied head) reaches
    ``repro_matmul_f32`` as the embedding's own storage, K-major, with the
    planner's path and split: one launch counted, no copy."""
    from repro_torch.kernels.matmul import plan_f32_gemm
    from repro_torch.models import layers as L

    emb = torch.randn(300, 64)                 # (V, d)
    x = torch.randn(1, 1, 64)
    L._mm(x, emb.T)
    (name, args), = fake_kernels
    assert name == "repro_matmul_f32"
    _, w_ptr, _, M, N, K, ldb, kmajor, path, bm, bn, split, scratch, _ = args
    assert w_ptr == emb.data_ptr()
    assert (M, N, K, ldb, kmajor) == (1, 300, 64, 64, 1)
    p = plan_f32_gemm(1, 300, 64, True)
    assert (path, bm, bn, split) == (0, p.bm, p.bn, p.split)
    assert (scratch is None) == (split == 1)
    assert ops.launch_counts()["matmul"] == 1


def test_decode_wrapper_passes_its_plan(fake_kernels):
    """``decode_attention`` hands its kernel ``plan_decode``'s cut and a
    scratch for the splits, at a head dim (80) that is not 32, 64 or
    128."""
    from repro_torch.kernels.attention import plan_decode

    B, W, H, KV, D = 1, 4096, 32, 32, 80
    q = torch.randn(B, H, D, dtype=torch.bfloat16)
    k = torch.randn(B, W, KV, D, dtype=torch.bfloat16)
    pos = torch.tensor([W - 1], dtype=torch.int32)
    out = ops.decode_attention(q, k, k, pos)
    assert out.shape == q.shape and out.dtype == q.dtype
    (name, args), = fake_kernels
    assert name == "repro_decode_attention_bf16"
    p = plan_decode(B, W, H, KV, D)
    assert p.split > 1 and args[7] is not None
    assert args[8:14] == (B, W, H, KV, D, 0)
    assert args[15:20] == (p.hg, p.hgroups, p.lpr, p.chunk, p.split)
    assert ops.launch_counts()["decode_attention"] == 1


def test_winograd_wrapper_passes_its_plan(fake_kernels):
    """``winograd_tile_matmul`` hands ``repro_winograd_tile_matmul_f32``
    the plan of ``plan_f32_gemm(T, O, C, batch=16)``: one launch counted."""
    from repro_torch.kernels.matmul import _PATH_CODE, plan_f32_gemm

    for T, C, O in [(12544, 64, 64), (784, 256, 256)]:
        fake_kernels.clear()
        ops.reset_launch_counts()
        V, U = torch.zeros(16, T, C), torch.zeros(16, C, O)
        out = ops.winograd_tile_matmul(V, U)
        assert out.shape == (16, T, O)
        (name, args), = fake_kernels
        assert name == "repro_winograd_tile_matmul_f32"
        p = plan_f32_gemm(T, O, C, False, 16)
        assert args[:3] == (V.data_ptr(), U.data_ptr(), out.data_ptr())
        assert args[3:7] == (16, T, C, O)
        assert args[7:12] == (_PATH_CODE[p.path], p.bm, p.bn, p.split,
                              p.blocks)
        assert (args[12] is None) == (p.split == 1)
        assert ops.launch_counts()["winograd_tile_matmul"] == 1


def test_flash_wrapper_passes_its_plan(fake_kernels):
    """``flash_attention`` at zamba2-2.7b's head dim 80 (outside the old
    {32, 64, 128}) reaches ``repro_flash_attention_bf16`` with
    ``plan_flash``'s cut and no lse buffer (inference): one launch
    counted."""
    from repro_torch.kernels.attention import plan_flash

    B, S, H, KV, D = 1, 1024, 32, 32, 80
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    k = torch.zeros(B, S, KV, D, dtype=torch.bfloat16)
    out = ops.flash_attention(q, k, k, causal=True, window=None,
                              softcap=None)
    assert out.shape == q.shape and out.dtype == q.dtype
    (name, args), = fake_kernels
    assert name == "repro_flash_attention_bf16"
    p = plan_flash(B, S, H, KV, D, torch.bfloat16, True, None)
    assert args[4] is None
    assert args[5:13] == (B, S, H, KV, D, 1, 0, 0.0)
    assert args[13:17] == (p.bq, p.heads, p.ksplit, p.dp)
    assert p.dp == 80 and p.dp >= D
    assert ops.launch_counts()["flash_attention"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 100), (64, 960, 2560),
                                   (3, 300, 150)])
def test_packed_wrapper_passes_its_plan(fake_kernels, M, K, N, dtype):
    """``matmul_packed`` hands ``repro_matmul_packed_f32`` (or ``_bf16``
    for a bf16 x) the panels in place and ``plan_f32_gemm(M, N, K)``'s
    path, tile and split, with a scratch only for a split; the output is
    in x's dtype: one launch counted."""
    from repro_torch.kernels.matmul import _PATH_CODE, plan_f32_gemm

    dt = getattr(torch, dtype)
    nK, nN = -(-K // 128), -(-N // 128)
    x, wp = torch.zeros(M, K, dtype=dt), torch.zeros(nN, nK, 128, 128)
    out = ops.matmul_packed(x, wp, K, N)
    assert out.shape == (M, N) and out.dtype == dt
    (name, args), = fake_kernels
    suffix = "bf16" if dt == torch.bfloat16 else "f32"
    assert name == f"repro_matmul_packed_{suffix}"
    assert args[:7] == (x.data_ptr(), wp.data_ptr(), out.data_ptr(), M, N,
                        K, nK)
    p = plan_f32_gemm(M, N, K)
    assert args[7:11] == (_PATH_CODE[p.path], p.bm, p.bn, p.split)
    assert (args[11] is None) == (p.split == 1)
    assert ops.launch_counts()["matmul_packed"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 100), (64, 960, 2560),
                                   (3, 129, 7)])
def test_dequant_int4_wrapper_passes_its_plan(fake_kernels, M, K, N, dtype):
    """``matmul_dequant_int4`` hands its kernel the packed bytes, the
    scale and ``plan_f32_gemm(M, N, K)``'s plan (the logical GEMM, not the
    packed rows), with a scratch only for a split: one launch counted."""
    from repro_torch.kernels.matmul import _PATH_CODE, plan_f32_gemm

    dt = getattr(torch, dtype)
    x = torch.zeros(M, K, dtype=dt)
    p4 = torch.zeros((K + 1) // 2, N, dtype=torch.uint8)
    s = torch.ones(1, N)
    out = ops.matmul_dequant_int4(x, p4, s, K)
    assert out.shape == (M, N) and out.dtype == dt
    (name, args), = fake_kernels
    suffix = "bf16" if dt == torch.bfloat16 else "f32"
    assert name == f"repro_matmul_dequant_int4_{suffix}"
    assert args[:7] == (x.data_ptr(), p4.data_ptr(), s.data_ptr(),
                        out.data_ptr(), M, N, K)
    p = plan_f32_gemm(M, N, K)
    assert args[7:11] == (_PATH_CODE[p.path], p.bm, p.bn, p.split)
    assert (args[11] is None) == (p.split == 1)
    assert ops.launch_counts()["matmul_dequant_int4"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 256, 100), (64, 960, 2560),
                                   (3, 129, 7)])
def test_dequant_int8_wrapper_passes_its_plan(fake_kernels, M, K, N, dtype):
    """``matmul_dequant_int8`` hands its kernel the int8 bytes, the scale
    and ``plan_f32_gemm(M, N, K)``'s plan, with a scratch only for a
    split: one launch counted."""
    from repro_torch.kernels.matmul import _PATH_CODE, plan_f32_gemm

    dt = getattr(torch, dtype)
    x = torch.zeros(M, K, dtype=dt)
    q8 = torch.zeros(K, N, dtype=torch.int8)
    s = torch.ones(1, N)
    out = ops.matmul_dequant_int8(x, q8, s)
    assert out.shape == (M, N) and out.dtype == dt
    (name, args), = fake_kernels
    suffix = "bf16" if dt == torch.bfloat16 else "f32"
    assert name == f"repro_matmul_dequant_int8_{suffix}"
    assert args[:7] == (x.data_ptr(), q8.data_ptr(), s.data_ptr(),
                        out.data_ptr(), M, N, K)
    p = plan_f32_gemm(M, N, K)
    assert args[7:11] == (_PATH_CODE[p.path], p.bm, p.bn, p.split)
    assert (args[11] is None) == (p.split == 1)
    assert ops.launch_counts()["matmul_dequant_int8"] == 1


# (E, C, d, n): granite-moe-3b-a800m's gate projection at decode (C 8) and
# at a 512-token prefill (C 208), and the Pallas sweep's d 32 and d 20
GMM_F32_SHAPES = [(40, 8, 1536, 512), (40, 208, 1536, 512),
                  (4, 64, 32, 48), (3, 40, 20, 9)]


@pytest.mark.parametrize("routed", [False, True])
@pytest.mark.parametrize("E,C,d,n", GMM_F32_SHAPES,
                         ids=["x".join(map(str, s)) for s in GMM_F32_SHAPES])
def test_gmm_f32_wrapper_passes_its_plan(fake_kernels, E, C, d, n, routed):
    """The f32 ``gmm_blocks`` hands ``repro_gmm_blocks_f32`` the group
    sizes as they lie (read on the device), a row-major w (K-major flag 0)
    and ``plan_f32_gemm(C, n, d, batch=E, row_limit=True)``'s plan: no
    stream path, which takes no row limit (without row limits the sweep's
    d 32 and d 20 would stream), batched skinny at decode, batched tile
    above; a scratch only for a split; one launch counted."""
    from repro_torch.kernels.matmul import _PATH_CODE, plan_f32_gemm

    x, w = torch.zeros(E, C, d), torch.zeros(E, d, n)
    gs = (torch.tensor([min(C, i) for i in range(E)], dtype=torch.int32)
          if routed else None)
    out = ops.gmm_blocks(x, w, gs)
    assert out.shape == (E, C, n) and out.dtype == torch.float32
    (name, args), = fake_kernels
    assert name == "repro_gmm_blocks_f32"
    assert args[:9] == (x.data_ptr(), w.data_ptr(), out.data_ptr(),
                        gs.data_ptr() if routed else None, E, C, d, n, 0)
    p = plan_f32_gemm(C, n, d, False, E, True)
    assert p.path == ("skinny" if C <= 16 else "tile")
    assert plan_f32_gemm(C, n, d, False, E).path == (
        "stream" if d <= 64 else "tile")
    assert args[9:13] == (_PATH_CODE[p.path], p.bm, p.bn, p.split)
    assert (args[13] is None) == (p.split == 1)
    assert ops.launch_counts()["gmm_blocks"] == 1


def test_int4_loader_widths():
    """The bytes of a packed row that the int4 kernel loads at once: 16
    where rows start on 16-byte boundaries (skinny only at M <= 4), 4 where
    N is a multiple of 4 (the resnet50 head's 100), 1 otherwise
    (``q_loader``, which the int8 kernel shares)."""
    from repro_torch.kernels.quant import q_loader

    def packed(rows, N, offset=0):
        buf = torch.zeros(rows * N + 64, dtype=torch.uint8)
        base = (-buf.data_ptr()) % 16 + offset
        return buf[base:base + rows * N].view(rows, N)

    assert q_loader(packed(480, 2560), 1, "skinny") == 16
    assert q_loader(packed(480, 2560), 4, "skinny") == 16
    assert q_loader(packed(480, 2560), 8, "skinny") == 4
    assert q_loader(packed(480, 2560), 64, "tile") == 16
    assert q_loader(packed(128, 100), 1, "skinny") == 4
    assert q_loader(packed(65, 7), 3, "skinny") == 1
    assert q_loader(packed(480, 2560, offset=4), 1, "skinny") == 4
    assert q_loader(packed(480, 2560, offset=1), 64, "tile") == 1
