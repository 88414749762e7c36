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


@pytest.mark.parametrize("T,C,O", [(200, 48, 72), (128, 128, 64),
                                   (60, 17, 9)])
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
    # neither a CPU nor a CUDA tensor: no plain fallback, no launch
    with pytest.raises(ValueError):
        ops.matmul(x.to("meta"), torch.zeros(8, 3, device="meta"))


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
