"""The port's MoE training slice (``kernels.gmm.gmm_blocks`` with a K-major
w and ``gmm_blocks_dw``, ``models.moe``'s ``_GroupedFFN`` and
``GroupedMatmul`` autograd Functions, the moe family through
``transformer.loss_fn`` with and without remat, ``train.make_train_step``
and ``launch.train``) against the JAX package's custom VJPs, on the CPU
at small size. Inputs come from numpy seeds; the reference makes the
params (``jax.random``) and ``transformer.from_reference`` carries them
over.

Tolerances, relative to the reference's max|ref|:
* the plain versions of the two backward products (``gmm_blocks`` with a
  K-major w, ``gmm_blocks_dw``) in f32: 1e-6 (the same f32 products
  summed in another order);
* ``_grouped_ffn`` and ``grouped_matmul``, value and gradients: 1e-5 in
  f32; 2e-2 in bf16 (a bf16 ulp is 2^-8 of a value, and the sums over k
  and over rows round at other places than jnp's);
* ``loss_fn``'s total, loss and aux loss and every gradient leaf of the
  reduced granite (f32): 1e-5; the train step's params, moments and
  metrics: 1e-4, as the dense step's (``test_torch_train.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.data import SyntheticPipeline as RefPipeline  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.models import moe as RM  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch import bf16  # noqa: E402
from repro_torch import optim as PA  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticPipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gmm import (gmm_blocks_dw_plain,  # noqa: E402
                                     gmm_blocks_plain)
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)
ARCH = "granite-moe-3b-a800m"


def _rng(*key):
    return np.random.default_rng(list(key))


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _t(a):
    return bf16.to_tensor(np.array(a))


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# the backward products' plain versions
# ---------------------------------------------------------------------------
# (E, C, d, n, group sizes): ragged C, d and n; an expert with no rows; a
# full and a partial one. Rows past each group hold other data.
PRODUCT_CASES = [(3, 40, 20, 9, (0, 17, 40)),
                 (4, 24, 33, 7, (5, 0, 24, 1)),
                 (2, 9, 5, 13, (9, 3))]


def _blocks(E, C, d, n, seed):
    rng = _rng(E, C, d, n, seed)
    x = (rng.standard_normal((E, C, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((E, d, n)) * d ** -0.5).astype(np.float32)
    dy = (rng.standard_normal((E, C, n)) * 0.5).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("E,C,d,n,sizes", PRODUCT_CASES)
def test_gmm_blocks_kmajor_plain_matches_ref(E, C, d, n, sizes):
    """dx = dy·wᵀ with the forward's w (E, n, d) read K-major as
    ``w.transpose(1, 2)``: against ``ref.gmm_ref`` on wᵀ copied, rows past
    the group sizes zero, the other rows the oracle's."""
    x, w, _ = _blocks(E, C, d, n, 1)
    wt = np.ascontiguousarray(np.swapaxes(w, 1, 2))          # (E, n, d)
    gs = torch.tensor(sizes, dtype=torch.int32)
    view = torch.from_numpy(wt).transpose(1, 2)               # (E, d, n)
    assert not view.is_contiguous() and view.transpose(1, 2).is_contiguous()
    before = ops.launch_counts()["gmm_blocks"]
    got = ops.gmm_blocks(torch.from_numpy(x), view, gs)
    assert ops.launch_counts()["gmm_blocks"] == before   # CPU: plain version
    want = _np(R.gmm_ref(jnp.asarray(x), jnp.asarray(w)))
    keep = np.arange(C)[None, :, None] < np.asarray(sizes)[:, None, None]
    assert _rel(got, np.where(keep, want, 0)) <= 1e-6
    assert not got.numpy()[~np.broadcast_to(keep, got.shape)].any()
    same = gmm_blocks_plain(torch.from_numpy(x), torch.from_numpy(w), gs)
    assert _rel(got, same) <= 1e-6


@pytest.mark.parametrize("E,C,d,n,sizes", PRODUCT_CASES)
def test_gmm_blocks_dw_plain_matches_reference_products(E, C, d, n, sizes):
    """dw[e] = x[e]ᵀ·dy[e] over the first ``sizes[e]`` rows: against the
    reference's own product, ``blk.T @ dg`` with dg masked past the group
    (``_grouped_ffn_bwd``), while the rows of x past the group hold other
    data; an expert with no rows gives zeros."""
    x, _, dy = _blocks(E, C, d, n, 2)
    keep = np.arange(C)[None, :, None] < np.asarray(sizes)[:, None, None]
    want = np.stack([_np(jnp.asarray(x[e]).T
                         @ jnp.where(keep[e], jnp.asarray(dy[e]), 0))
                     for e in range(E)])
    gs = torch.tensor(sizes, dtype=torch.int32)
    before = ops.launch_counts()["gmm_blocks_dw"]
    got = ops.gmm_blocks_dw(torch.from_numpy(x), torch.from_numpy(dy), gs)
    assert ops.launch_counts()["gmm_blocks_dw"] == before
    assert got.shape == (E, d, n) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6
    for e, s in enumerate(sizes):
        if s == 0:
            assert not got[e].any()
    # no group sizes: every row (the oracle's einsum)
    full = gmm_blocks_dw_plain(torch.from_numpy(x), torch.from_numpy(dy))
    assert _rel(full, np.einsum("ecd,ecn->edn", x, dy)) <= 1e-6


def test_gmm_blocks_dw_ignores_rows_past_the_groups():
    """Rows past a group add nothing, whatever they hold (inf, NaN)."""
    x = torch.ones(2, 6, 3)
    dy = torch.ones(2, 6, 4)
    x[0, 2:] = float("inf")
    dy[1, 4:] = float("nan")
    got = ops.gmm_blocks_dw(x, dy, torch.tensor([2, 4], dtype=torch.int32))
    assert torch.equal(got[0], torch.full((3, 4), 2.0))
    assert torch.equal(got[1], torch.full((3, 4), 4.0))


def test_gmm_blocks_dw_plain_nan_past_groups_matches_reference_bwd():
    """The three dw of the reference's ``_grouped_ffn_bwd`` (dwg = blkᵀ·dg,
    dwu = blkᵀ·du, dwd = hᵀ·dyb, scanned over the experts) against
    ``gmm_blocks_dw_plain`` on the same blocks with every row past a
    group NaN in both operands (where the kernel's rows hold the next
    expert's tokens): the rows within the groups alone reach the result,
    an expert with no rows gives zeros."""
    E, d, ff, C = 3, 16, 24, 12
    sizes = np.array([5, 0, 9])
    M = int(sizes.sum())
    rng = _rng(E, d, ff, C, 9)
    xs = (rng.standard_normal((M, d)) * 0.5).astype(np.float32)
    wg, wu = ((rng.standard_normal((E, d, ff)) * d ** -0.5).astype(
        np.float32) for _ in range(2))
    wd = (rng.standard_normal((E, ff, d)) * ff ** -0.5).astype(np.float32)
    dy = rng.standard_normal((M, d)).astype(np.float32)
    _, _, dwg, dwu, dwd = RM._grouped_ffn_bwd(
        C, (jnp.asarray(xs), jnp.asarray(sizes), jnp.asarray(wg),
            jnp.asarray(wu), jnp.asarray(wd)), jnp.asarray(dy))
    # the blocks of the reference's scan body, in f32 numpy
    offsets = np.cumsum(sizes) - sizes
    rows = offsets[:, None] + np.arange(C)[None, :]
    keep = (np.arange(C)[None, :] < sizes[:, None])[..., None]
    blk = np.pad(xs, ((0, C), (0, 0)))[rows]
    dyb = np.where(keep, np.pad(dy, ((0, C), (0, 0)))[rows], 0)
    g, u = blk @ wg, blk @ wu
    sg = 1 / (1 + np.exp(-g))
    silu_g = g * sg
    h = silu_g * u
    dh = dyb @ np.swapaxes(wd, 1, 2)
    du = dh * silu_g
    dg = dh * u * (sg * (1 + g * (1 - sg)))
    gs = torch.tensor(sizes, dtype=torch.int32)

    def nan_past(a):
        return torch.from_numpy(np.where(keep, a, np.nan).astype(np.float32))

    for a, b, want in ((blk, dg, dwg), (blk, du, dwu), (h, dyb, dwd)):
        got = gmm_blocks_dw_plain(nan_past(a), nan_past(b), gs)
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-5
        assert not got[1].any()


def test_gmm_dw_plan_routes_by_alignment_and_divisibility():
    """``plan_gmm_dw``: bf16 with d and n multiples of 8 and aligned bases
    takes the TMA kernel (``min(tiles, SMS)`` persistent blocks of 128 x 128
    tiles, ``ceil(C / 64)`` K steps); an unaligned base or a d or n off the
    8-element grid takes the tile path at ``plan_bf16_gemm``'s tiles and
    split, never the skinny path (which takes no M-major A); f32 takes
    ``plan_f32_gemm``'s tile plan."""
    from repro_torch.kernels.gmm import plan_gmm_dw
    from repro_torch.kernels.matmul import (SMS, plan_bf16_gemm,
                                            plan_f32_gemm)

    bf, f32 = torch.bfloat16, torch.float32
    assert plan_gmm_dw(1536, 512, 824, 40, bf) == ("tma", 128, 128, 1, 13,
                                                   SMS)
    # few tiles: one persistent block a tile (chip_smoke.py's ragged TMA
    # row: boxes past d 200 and n 72, six tiles)
    assert plan_gmm_dw(64, 64, 100, 3, bf) == ("tma", 128, 128, 1, 2, 3)
    assert plan_gmm_dw(200, 72, 40, 3, bf) == ("tma", 128, 128, 1, 1, 6)
    for d, n, aligned in ((1536, 512, False), (20, 512, True),
                          (1536, 9, True), (12, 40, True)):
        p = plan_gmm_dw(d, n, 824, 40, bf, aligned)
        q = plan_bf16_gemm(d, n, 824, 40)
        assert p.path == "tile", (d, n, aligned)
        if q.path == "tile":
            assert p == q
        else:   # d <= 16: the tile path in 64-row tiles
            assert p.bm == 64 and q.path == "skinny"
    for d, n in ((1536, 512), (12, 40), (8, 8)):
        p = plan_gmm_dw(d, n, 824, 40, f32)
        assert p.path == "tile"
        if d > 16:
            assert p == plan_f32_gemm(d, n, 824, False, 40, True)


def test_gmm_blocks_dw_bf16_rounds_once():
    """bf16 in, an f32 sum, the result rounded to bf16 once."""
    rng = _rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 16, 5)).astype(np.float32))
    xb, dyb = x.to(torch.bfloat16), dy.to(torch.bfloat16)
    gs = torch.tensor([16, 7, 0], dtype=torch.int32)
    got = ops.gmm_blocks_dw(xb, dyb, gs)
    assert got.dtype == torch.bfloat16
    want = gmm_blocks_dw_plain(xb.float(), dyb.float(), gs).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_gmm_blocks_dw_wrapper_checks():
    x, dy = torch.zeros(2, 8, 4), torch.zeros(2, 8, 3)
    with pytest.raises(ValueError):
        ops.gmm_blocks_dw(x, torch.zeros(2, 7, 3))
    with pytest.raises(ValueError):
        ops.gmm_blocks_dw(x, dy, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="gmm_blocks_dw"):
        ops.gmm_blocks_dw(x.requires_grad_(), dy)
    with torch.no_grad():
        assert ops.gmm_blocks_dw(x, dy).shape == (2, 4, 3)


def test_f32_planner_puts_a_kmajor_w_on_the_tile_path():
    """dx with a K-major w and row limits plans the batched tile path at
    any C (the grouped skinny path reads a row-major w only); a row-major
    w at decode keeps the skinny path."""
    from repro_torch.kernels.matmul import plan_f32_gemm

    assert plan_f32_gemm(8, 512, 1536, True, 40, True).path == "tile"
    assert plan_f32_gemm(824, 512, 1536, True, 40, True).path == "tile"
    assert plan_f32_gemm(8, 512, 1536, False, 40, True).path == "skinny"
    # gmm_blocks_dw at granite's training microbatch: the tile path
    assert plan_f32_gemm(1536, 512, 824, False, 40, True).path == "tile"


@pytest.fixture
def fake_kernels(monkeypatch):
    """Run a wrapper's CUDA branch on CPU tensors against a stand-in
    library that records each C call's arguments (no CUDA here)."""
    import contextlib

    from repro_torch.kernels import _native

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


# granite-moe-3b-a800m's training microbatch (E 40, C 824, d 1536, ff 512)
# and a ragged shape
TRAIN_SHAPES = [(40, 824, 1536, 512), (3, 40, 20, 9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,n", TRAIN_SHAPES)
def test_gmm_dx_wrapper_reads_w_kmajor_in_place(fake_kernels, E, C, d, n,
                                                dtype):
    """dx = dy·wᵀ: ``gmm_blocks(dy, w.transpose(1, 2), gs)`` hands the C
    entry the forward's weight storage uncopied with the K-major flag 1
    and the planner's path, tile and split (bf16: ``plan_bf16_gemm(C, n,
    d, E)``; f32: ``plan_f32_gemm(C, n, d, True, E, True)``, the tile
    path); one ``gmm_blocks`` launch counted."""
    from repro_torch.kernels.matmul import (_PATH_CODE, plan_bf16_gemm,
                                            plan_f32_gemm)

    dy = torch.zeros(E, C, d, dtype=dtype)
    w = torch.zeros(E, n, d, dtype=dtype)          # the forward's (E, n, d)
    gs = torch.zeros(E, dtype=torch.int32)
    out = ops.gmm_blocks(dy, w.transpose(1, 2), gs)
    assert out.shape == (E, C, n) and out.dtype == dtype
    (name, args), = fake_kernels
    assert args[:9] == (dy.data_ptr(), w.data_ptr(), out.data_ptr(),
                        gs.data_ptr(), E, C, d, n, 1)
    if dtype == torch.bfloat16:
        assert name == "repro_gmm_blocks_bf16"
        p = plan_bf16_gemm(C, n, d, E)
        assert args[9:12] == (_PATH_CODE[p.path], p.bm, p.split)
    else:
        assert name == "repro_gmm_blocks_f32"
        p = plan_f32_gemm(C, n, d, True, E, True)
        assert p.path == "tile"
        assert args[9:13] == (_PATH_CODE[p.path], p.bm, p.bn, p.split)
    assert ops.launch_counts()["gmm_blocks"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,n", TRAIN_SHAPES)
def test_gmm_dw_wrapper_passes_group_sizes_as_k_limits(fake_kernels, E, C,
                                                       d, n, dtype):
    """``gmm_blocks_dw(x, dy, gs)`` hands its kernel x and dy in place (no
    xᵀ copy: x is read M-major), the group sizes as they lie (each
    expert's K limit, read on the device) and ``plan_gmm_dw``'s plan of
    (d, n, C, E): in bf16 at granite's shape (d, n multiples of 8, aligned)
    ``repro_gmm_blocks_dw_tma_bf16`` with its persistent blocks, at the
    ragged shape ``repro_gmm_blocks_dw_bf16`` on the tile path with a
    scratch only for a split; in f32 ``repro_gmm_blocks_dw_f32`` on the
    tile path. One ``gmm_blocks_dw`` launch counted, none of
    ``gmm_blocks``; a bf16 launch counted by its path."""
    from repro_torch.kernels.gmm import plan_gmm_dw
    from repro_torch.kernels.matmul import _PATH_CODE

    x = torch.zeros(E, C, d, dtype=dtype)
    dy = torch.zeros(E, C, n, dtype=dtype)
    gs = torch.zeros(E, dtype=torch.int32)
    out = ops.gmm_blocks_dw(x, dy, gs)
    assert out.shape == (E, d, n) and out.dtype == dtype
    (name, args), = fake_kernels
    assert args[:8] == (x.data_ptr(), dy.data_ptr(), out.data_ptr(),
                        gs.data_ptr(), E, C, d, n)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, out))
    p = plan_gmm_dw(d, n, C, E, dtype, aligned)
    if dtype == torch.bfloat16 and p.path == "tma":
        assert name == "repro_gmm_blocks_dw_tma_bf16"
        assert (E, C, d, n) == (40, 824, 1536, 512)
        assert args[8] == p.blocks and len(args) == 10
        assert p.blocks == 132
        assert ops.gemm_path_counts()["tma"] == 1
    elif dtype == torch.bfloat16:
        assert name == "repro_gmm_blocks_dw_bf16"
        assert p.path == "tile"
        assert args[8:11] == (_PATH_CODE[p.path], p.bm, p.split)
        assert (args[11] is None) == (p.split == 1)
        assert ops.gemm_path_counts()["tile"] == 1
    else:
        assert name == "repro_gmm_blocks_dw_f32"
        assert p.path == "tile"
        assert args[8:12] == (_PATH_CODE[p.path], p.bm, p.bn, p.split)
        assert (args[12] is None) == (p.split == 1)
    counts = ops.launch_counts()
    assert counts["gmm_blocks_dw"] == 1 and counts["gmm_blocks"] == 0


def test_plans_at_the_training_microbatch():
    """The plans the backward's products take at granite's training
    microbatch (E 40, C 824, d 1536, ff 512), frozen: dx (dh (C, ff, d),
    dblk (C, d, ff)) on the bf16 tile path with 128-row tiles and no split
    (1120 to 3360 tiles) and on the f32 tile path in 128 x 128 tiles,
    likewise unsplit; dw (dwg (d, ff, C), dwd (ff, d, C)) through
    ``plan_gmm_dw``: in bf16 the TMA kernel's 128 x 128 tiles over 132
    persistent blocks, 13 K steps of 64 rows; in f32 the tile path in 128 x
    128 tiles, unsplit, its 52 K steps of 16."""
    from repro_torch.kernels.gmm import plan_gmm_dw
    from repro_torch.kernels.matmul import plan_bf16_gemm, plan_f32_gemm

    E, C, d, ff = 40, 824, 1536, 512
    for M, N, K in ((C, ff, d), (C, d, ff)):
        p = plan_bf16_gemm(M, N, K, E)
        assert (p.path, p.bm, p.split) == ("tile", 128, 1), (M, N, K)
        q = plan_f32_gemm(M, N, K, True, E, True)
        assert (q.path, q.bm, q.bn, q.split) == ("tile", 128, 128, 1)
    for M, N in ((d, ff), (ff, d)):
        p = plan_gmm_dw(M, N, C, E, torch.bfloat16)
        assert p == ("tma", 128, 128, 1, 13, 132), (M, N)
        q = plan_gmm_dw(M, N, C, E, torch.float32)
        assert (q.path, q.bm, q.bn, q.split, q.ksteps) == ("tile", 128,
                                                           128, 1, 52)


# ---------------------------------------------------------------------------
# _grouped_ffn and grouped_matmul against the reference's custom VJPs
# ---------------------------------------------------------------------------
def _ffn_case(case, dtype):
    """(xs, sizes, wg, wu, wd, dy, C) as numpy f32 (dtype applied by the
    caller): no drops; a capacity that drops tokens (the reference's
    ``test_moe_capacity_drops_tokens`` shapes); an empty expert."""
    rng = _rng(len(case), ord(case[0]))
    E, d, ff = 4, 16, 24
    if case == "no_drops":
        sizes = np.array([5, 9, 2, 8])
        C = 16
    elif case == "drops":
        E, d, ff = 2, 4, 8
        sizes = np.array([12, 0])
        C = 8
    else:   # "empty_expert"
        sizes = np.array([7, 0, 11, 3])
        C = 16
    M = int(sizes.sum())
    xs = (rng.standard_normal((M, d)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.3).astype(np.float32)
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    dy = rng.standard_normal((M, d)).astype(np.float32)
    return xs, sizes, ws, dy, C


def _cast(a, dtype):
    """numpy f32 -> (a jnp array, a torch tensor) in ``dtype``, the same
    values."""
    j = jnp.asarray(a, dtype)
    return j, _t(j)


@pytest.mark.parametrize("case", ["no_drops", "drops", "empty_expert"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_ffn_value_and_grads_match_reference(case, dtype):
    """The value and the four gradients (xs, w_gate, w_up, w_down) of
    ``_grouped_ffn`` under one cotangent, against ``jax.vjp`` of the
    reference's (its custom VJP)."""
    xs, sizes, ws, dy, C = _ffn_case(case, dtype)
    jx, tx = _cast(xs, dtype)
    jw, tw = zip(*[_cast(w, dtype) for w in ws])
    jdy, tdy = _cast(dy, dtype)
    jgs = jnp.asarray(sizes, jnp.int32)
    y_r, vjp = jax.vjp(lambda x, a, b, c: RM._grouped_ffn(x, jgs, a, b, c, C),
                       jx, *jw)
    grads_r = vjp(jdy)
    leaves = [t.clone().requires_grad_() for t in (tx, *tw)]
    y = M._grouped_ffn(leaves[0], torch.from_numpy(sizes), *leaves[1:], C)
    assert y.grad_fn is not None and y.dtype == tx.dtype
    grads = torch.autograd.grad(y, leaves, tdy)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel(y, y_r) <= tol
    for name, g, r in zip(("xs", "w_gate", "w_up", "w_down"), grads,
                          grads_r):
        assert g.dtype == tx.dtype, name
        assert _rel(g, r) <= tol, (name, _rel(g, r))
    if case == "drops":    # the tokens past C get no gradient
        assert not grads[0][C:].any()


@pytest.mark.parametrize("seed", range(3))
def test_grouped_ffn_backward_matches_autograd_of_plain_forward(seed,
                                                                monkeypatch):
    """``_GroupedFFN``'s hand-written backward against torch autograd
    through its forward with the plain versions swapped in for the
    kernels (what the card's path is held to), in f32: 1e-5."""
    rng = _rng(seed, 11)
    E, d, ff = 3, 8, 12
    sizes = rng.multinomial(20, np.ones(E) / E)
    C = 8
    xs = torch.from_numpy(rng.standard_normal((20, d)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal(s) * 0.3).astype(np.float32))
          for s in ((E, d, ff), (E, d, ff), (E, ff, d))]
    dy = torch.from_numpy(rng.standard_normal((20, d)).astype(np.float32))
    gs = torch.from_numpy(sizes)
    outs = []
    for fn in (M._grouped_ffn, M._grouped_ffn_fwd):
        if fn is M._grouped_ffn_fwd:
            monkeypatch.setattr(ops, "gmm_blocks", gmm_blocks_plain)
        leaves = [t.clone().requires_grad_() for t in (xs, *ws)]
        y = fn(leaves[0], gs, *leaves[1:], C)
        outs.append([y] + list(torch.autograd.grad(y, leaves, dy)))
    for a, b in zip(*outs):
        assert _rel(a, b) <= 1e-5


def test_grouped_ffn_launches_eight_kernels_in_its_backward(monkeypatch):
    """The backward calls ``gmm_blocks`` five times (g and u recomputed,
    dh, dblk's two products) with the weights K-major in place where
    transposed, and ``gmm_blocks_dw`` three times, every call with the
    int32 group sizes; the forward calls ``gmm_blocks`` three times."""
    xs, sizes, ws, dy, C = _ffn_case("empty_expert", "float32")
    calls = []
    real_mm, real_dw = ops.gmm_blocks, ops.gmm_blocks_dw

    def mm(x, w, group_sizes=None):
        calls.append(("gmm_blocks", w.is_contiguous(), group_sizes))
        return real_mm(x, w, group_sizes)

    def dw(x, g, group_sizes=None):
        calls.append(("gmm_blocks_dw", True, group_sizes))
        return real_dw(x, g, group_sizes)

    monkeypatch.setattr(ops, "gmm_blocks", mm)
    monkeypatch.setattr(ops, "gmm_blocks_dw", dw)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xs, *ws)]
    y = M._grouped_ffn(leaves[0], torch.from_numpy(sizes), *leaves[1:], C)
    assert [c[0] for c in calls] == ["gmm_blocks"] * 3
    calls.clear()
    torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert sorted(c[0] for c in calls) == ["gmm_blocks"] * 5 \
        + ["gmm_blocks_dw"] * 3
    assert sum(not c[1] for c in calls) == 3      # dh and dblk: wᵀ in place
    for _, _, gs in calls:
        assert gs.dtype == torch.int32 and gs.tolist() == sizes.tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [(3, 0, 6, 2), (11, 0, 0, 0),
                                   (1, 2, 3, 4)])
def test_grouped_matmul_value_and_grads_match_reference(dtype, sizes):
    """``grouped_matmul`` (``ragged_dot``) and both gradients against
    ``jax.vjp`` of the reference's custom VJP; rows past the groups' sum
    (11 rows) are zero with no gradient."""
    rng = _rng(*sizes)
    M_, E, d, n = 11, 4, 10, 6
    x = (rng.standard_normal((M_, d)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((E, d, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((M_, n)).astype(np.float32)
    jx, tx = _cast(x, dtype)
    jw, tw = _cast(w, dtype)
    jdy, tdy = _cast(dy, dtype)
    jgs = jnp.asarray(sizes, jnp.int32)
    y_r, vjp = jax.vjp(lambda a, b: RM.grouped_matmul(a, b, jgs), jx, jw)
    dx_r, dw_r = vjp(jdy)
    lx, lw = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    y = M.grouped_matmul(lx, lw, torch.tensor(sizes))
    dx, dw = torch.autograd.grad(y, (lx, lw), tdy)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for got, want in ((y, y_r), (dx, dx_r), (dw, dw_r)):
        assert got.dtype == tx.dtype
        assert _rel(got, want) <= tol
    used = sum(sizes)
    assert not y[used:].any() and not dx[used:].any()
    with torch.no_grad():
        assert torch.equal(M.grouped_matmul(tx, tw, torch.tensor(sizes)),
                           y.detach())


# ---------------------------------------------------------------------------
# the token gather and un-permute
# ---------------------------------------------------------------------------
def test_token_gather_and_permute_reverse_autograds():
    """``_TokenGather`` and ``_Permute`` give autograd's own gradients of
    ``xf[perm // k]`` and ``ys[inv]`` (f32: the same sums, here exact in
    any order), and two backward passes the same bits."""
    rng = _rng(3)
    T_, k, d = 6, 3, 5
    perm = torch.argsort(torch.from_numpy(rng.integers(0, 4, T_ * k)),
                         stable=True)
    inv = torch.argsort(perm)
    xf = torch.from_numpy(rng.integers(-4, 4, (T_, d)).astype(np.float32))
    dxs = torch.from_numpy(rng.integers(-4, 4, (T_ * k, d)).astype(
        np.float32))
    a = xf.clone().requires_grad_()
    got = torch.autograd.grad(M._TokenGather.apply(a, perm, inv, k), a,
                              dxs)[0]
    want = torch.autograd.grad(a[perm // k], a, dxs)[0]
    assert torch.equal(got, want)
    again = torch.autograd.grad(M._TokenGather.apply(a, perm, inv, k), a,
                                dxs)[0]
    assert torch.equal(got, again)
    ys = dxs.clone().requires_grad_()
    got = torch.autograd.grad(M._Permute.apply(ys, inv, perm), ys, dxs)[0]
    want = torch.autograd.grad(ys[inv], ys, dxs)[0]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the moe family through loss_fn
# ---------------------------------------------------------------------------
def _cfgs(**over):
    over.setdefault("dtype", "float32")
    return (ref_get_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**over))


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


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_fn_and_grads_match_reference(remat, seed):
    """Granite reduced (2 layers, 4 experts, top-2, f32): ``loss_fn``'s
    total, loss and aux loss and every gradient leaf (router, experts,
    attention, norms, embed) against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, with and without remat: 1e-5."""
    rcfg, cfg = _cfgs()
    rp, pp = _params(rcfg, seed)
    rb, pb = _tokens(cfg, 2, 24, seed)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(p, b, rcfg), has_aux=True))(rp, rb)
    leaves = _requires_grad(pp)
    total, m = T.loss_fn(pp, pb, cfg, remat=remat)
    for got, want in ((total, rl), (m["loss"], rm["loss"]),
                      (m["aux_loss"], rm["aux_loss"])):
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert m["aux_loss"].item() > 0
    grads = pytree.unflatten(pp, torch.autograd.grad(total, leaves))
    rels = _leaf_rels(grads, rg)
    assert any("router" in k for k, _ in rels)
    for key, rel in rels:
        assert rel <= 1e-5, (key, rel)


def test_remat_carries_the_aux_loss_bitwise():
    """``forward(remat=True)`` returns the aux loss bit for bit as without
    remat (per block and per group of two of four blocks), and its
    gradient reaches the router: the 0.01·aux term alone differentiates
    to the same router gradient either way."""
    _, cfg = _cfgs(num_layers=4)
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    _, pb = _tokens(cfg, 2, 16, 1)
    leaves = _requires_grad(pp)
    router = pp["blocks"]["moe"]["router"]
    runs = []
    for remat, group in ((False, 1), (True, 1), (True, 2)):
        _, aux, _ = T.forward(pp, pb, cfg, remat=remat, remat_group=group)
        runs.append((aux, torch.autograd.grad(aux, router)[0]))
    assert runs[0][0].item() > 0 and runs[0][1].abs().max() > 0
    for aux, g in runs[1:]:
        assert torch.equal(aux, runs[0][0]) and torch.equal(g, runs[0][1])
    assert len(leaves) == len(pytree.leaves(pp))


def test_remat_recompute_routes_as_the_first_forward(monkeypatch):
    """Under remat, the backward's recomputed forward calls ``route`` once
    more a layer and picks the same experts as the first forward did, and
    the loss and every gradient leaf equal the run without remat bit for
    bit; two backward passes are bitwise equal too."""
    _, cfg = _cfgs(num_layers=4)
    pp = T.init_params(cfg, torch.Generator().manual_seed(2))
    _, pb = _tokens(cfg, 2, 16, 2)
    leaves = _requires_grad(pp)
    log = []
    route = M.route

    def recording(xf, router, c):
        out = route(xf, router, c)
        log.append(out[2].clone())
        return out

    monkeypatch.setattr(M, "route", recording)
    runs = []
    for remat in (False, True, True, False):
        log.clear()
        total, _ = T.loss_fn(pp, pb, cfg, remat=remat)
        n_fwd = len(log)
        runs.append([total] + list(torch.autograd.grad(total, leaves)))
        assert n_fwd == cfg.num_layers
        if remat:   # the recompute's routing: the last layer's first
            assert len(log) == 2 * cfg.num_layers
            for a, b in zip(log[:n_fwd], reversed(log[n_fwd:])):
                assert torch.equal(a, b)
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def test_bf16_backward_passes_bitwise_equal():
    """Granite reduced in bf16: two ``loss_fn`` backward passes give the
    same loss and gradient bits, with remat as without."""
    _, cfg = _cfgs(dtype="bfloat16")
    pp = T.init_params(cfg, torch.Generator().manual_seed(4))
    _, pb = _tokens(cfg, 2, 16, 4)
    leaves = _requires_grad(pp)
    runs = []
    for remat in (False, False, True):
        total, _ = T.loss_fn(pp, pb, cfg, remat=remat)
        runs.append([total] + list(torch.autograd.grad(total, leaves)))
    assert all(g.dtype == p.dtype for g, p in zip(runs[0][1:], leaves))
    assert pp["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_and_hybrid_train_beside_moe(arch):
    """No family refuses gradients any more: ssm and hybrid give a finite
    loss whose gradient reaches the mamba weights, as moe's reaches the
    router."""
    cfg = get_config(arch).reduced(dtype="float32")
    pp = T.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = _requires_grad(pp)
    _, pb = _tokens(cfg, 1, 32)
    total, _ = T.loss_fn(pp, pb, cfg)
    grads = pytree.unflatten(pp, torch.autograd.grad(total, leaves))
    assert bool(torch.isfinite(total))
    assert grads["blocks"]["mamba"]["A_log"].abs().max() > 0


# ---------------------------------------------------------------------------
# the train step and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Two ``make_train_step`` steps (remat on) against the reference's
    jitted step on the same ``SyntheticPipeline`` data: params, f32
    moments and metrics (loss, aux loss, grad norm, lr) within 1e-4 of
    max|ref|, the params updated in place (the stacked (L, E, d, ff)
    expert leaves among them)."""
    rcfg, cfg = _cfgs(vocab_size=256)
    kw = dict(lr=3e-4, warmup=100, total_steps=1000,
              num_microbatches=microbatches)
    ref_step = jax.jit(ref_make_train_step(rcfg, remat=False, **kw))
    rpipe = RefPipeline(rcfg, 4, 16, microbatches=microbatches, seed=3)
    ppipe = SyntheticPipeline(cfg, 4, 16, microbatches=microbatches, seed=3,
                              device="cpu")
    rp, pp = _params(rcfg, seed=5)
    rs, ps = RA.adamw_init(rp), PA.adamw_init(pp)
    step = make_train_step(cfg, remat=True, **kw)
    ids = [id(p) for p in pytree.leaves(pp)]
    assert pp["blocks"]["moe"]["w_gate"].dim() == 4
    for i in range(2):
        rp, rs, rm = ref_step(rp, rs, rpipe.batch_at(i))
        pp, ps, pm = step(pp, ps, ppipe.batch_at(i))
        assert [id(p) for p in pytree.leaves(pp)] == ids
        for k in ("loss", "aux_loss", "grad_norm", "lr"):
            assert abs(float(pm[k]) - float(rm[k])) <= 1e-4 * abs(
                float(rm[k])), (i, k)
        for key, rel in (_leaf_rels(pp, rp) + _leaf_rels(ps.m, rs.m)
                         + _leaf_rels(ps.v, rs.v)):
            assert rel <= 1e-4, (i, key, rel)


def test_launch_train_granite_on_cpu(capsys):
    """``python -m repro_torch.launch.train --arch granite-moe-3b-a800m
    --reduced --device cpu`` runs its steps with finite losses."""
    from repro_torch.launch import train as LT

    final = LT.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                     "--steps", "2", "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    losses = [float(l.split()[3]) for l in out.splitlines()
              if l.startswith("step")]
    assert "granite-moe-3b-a800m-reduced" in out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] == pytest.approx(final, abs=1e-4)
