"""The port's step counter (``roofline.op_cost``) and roofline report
(``roofline.analysis``), on the CPU and on meta tensors: the twins of the
reference's ``hlo_cost`` tests (``tests/test_substrates.py``), the
kernel wrappers' cost functions, and a reduced model's count, the same on
the CPU (where each wrapper runs its plain version, whose ops its own cost
stands for) as on meta (where it returns its outputs' shapes only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch import quant  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import attention as A  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd import _ssd_forward as ssd_forward  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.pytree import tree_map  # noqa: E402
from repro_torch.roofline.analysis import roofline_terms  # noqa: E402
from repro_torch.roofline.op_cost import OpCounter  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)


def _count(fn, *args):
    with OpCounter() as c:
        fn(*args)
    return c.cost


def test_loop_free_matmul_matches_flop_counter():
    """2·M·N·K, within 5 % of torch's own FlopCounterMode; bytes the
    operands plus the result."""
    a = torch.ones(256, 128, dtype=torch.bfloat16)
    b = torch.ones(128, 64, dtype=torch.bfloat16)
    cost = _count(torch.matmul, a, b)
    with FlopCounterMode(display=False) as fc:
        torch.matmul(a, b)
    assert cost.flops == 2 * 256 * 64 * 128
    assert abs(cost.flops - fc.get_total_flops()) <= 0.05 * cost.flops
    assert cost.hbm_bytes == 2 * (256 * 128 + 128 * 64 + 256 * 64)


def test_repeated_products_count_each_time():
    x = torch.ones(128, 128)

    def seven(x):
        y = x
        for _ in range(7):
            y = y @ x
        return y

    assert _count(seven, x).flops == 7 * _count(torch.matmul, x, x).flops


def test_view_ops_cost_nothing():
    x = torch.ones(4, 8, 16)

    def views(x):
        y = x.view(32, 16).transpose(0, 1)[2:5].unsqueeze(0)
        z = x.reshape(4, 128).expand(3, 4, 128)
        return y.select(1, 0), z, x.permute(2, 0, 1), x.detach()

    cost = _count(views, x)
    assert (cost.flops, cost.hbm_bytes, cost.ops) == (0, 0, 0)


def test_elementwise_reductions_and_transcendentals():
    x = torch.ones(10, 20)
    cost = _count(lambda x: torch.exp(x).sum(dim=-1), x)
    assert cost.flops == 200 + 10
    assert cost.transcendentals == 200
    assert cost.hbm_bytes == 4 * (200 + 200) + 4 * (200 + 10)
    # an expanded operand is read once
    cost = _count(lambda a, b: a + b, x, torch.ones(20).expand(10, 20))
    assert cost.hbm_bytes == 4 * (200 + 20 + 200)


def test_live_bytes_peak():
    x = torch.ones(1000)
    with OpCounter() as c:
        c.track({"x": x})
        y = torch.ones(1000) * 2          # ones (4 KB) and y (4 KB)
        del y
        z = torch.zeros(500)
    assert c.cost.arg_bytes == 4000
    assert c.cost.peak_bytes == 4000 + 8000
    del z


def test_collective_terms_are_zero_on_one_card():
    r = roofline_terms(arch="a", shape="s", mesh_name="1x1", chips=1,
                       flops=2e12, hbm_bytes=1e9, model_flops=1e12,
                       peak_flops=1e15, hbm_bw=1e12)
    assert (r.wire_bytes_per_device, r.collective_s,
            r.collective_by_kind) == (0.0, 0.0, {})
    assert r.flashable_hbm_bytes == 0.0 and r.memory_s_flash == r.memory_s
    assert r.bottleneck == "compute" and r.useful_flops_ratio == 0.5
    assert set(r.to_dict()) >= {
        "arch", "shape", "mesh", "chips", "flops_per_device",
        "hbm_bytes_per_device", "wire_bytes_per_device", "compute_s",
        "memory_s", "collective_s", "bottleneck", "model_flops",
        "useful_flops_ratio", "peak_memory_bytes", "collective_by_kind",
        "flashable_hbm_bytes", "memory_s_flash"}


@pytest.mark.parametrize("S,causal,window", [
    (16, True, None), (16, True, 5), (33, True, 40), (16, False, None),
    (20, False, 6), (1, True, 1)])
def test_visible_pairs_counts_the_masks_pairs(S, causal, window):
    r = np.arange(S)[:, None]
    c = np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= c <= r
    if window is not None:
        ok &= c > r - window
    assert A.visible_pairs(S, causal, window) == int(ok.sum())


def _kernel_calls():
    """(name, call, the cost the bound column counts) of each costed
    wrapper at a small shape, on the CPU."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    bf = torch.bfloat16
    x, w = r(6, 40, dtype=bf), r(40, 24, dtype=bf)
    q, k, v = r(2, 16, 4, 32), r(2, 16, 2, 32), r(2, 16, 2, 32)
    o, lse = A._flash_forward(q, k, v, True, 5, None, True)
    dq = r(3, 4, 32)
    kc, vc = r(3, 10, 2, 32), r(3, 10, 2, 32)
    pos = torch.tensor([9, 4, 12], dtype=torch.int32)
    gx, gw, gdy = r(3, 8, 16), r(3, 16, 12), r(3, 8, 12)
    gs = torch.tensor([8, 3, 0], dtype=torch.int32)
    B, S, H, P, N, Q = 1, 16, 2, 8, 4, 8
    sx, sdt = r(B, S, H, P), r(B, S, H).abs()
    sA, sD = -r(H).abs(), r(H)
    sB, sC = r(B, S, N), r(B, S, N)
    y, _, (cum, cb, ins) = ssd_forward(sx, sdt, sA, sB, sC, sD, Q, None,
                                       True)
    nc, pairs = S // Q, Q * (Q + 1) // 2
    a = np.random.default_rng(0).standard_normal((9, 7)).astype(np.float32)
    q8, s8, _ = quant.quantize_int8(a)
    p4, s4 = quant.quantize_int4(a)
    return [
        ("matmul", lambda: ops.matmul(x, w, out_dtype=torch.float32),
         (2 * 6 * 24 * 40, 2 * (6 * 40 + 40 * 24) + 4 * 6 * 24)),
        ("flash_attention", lambda: ops.flash_attention(q, k, v, window=5),
         (4 * 2 * 4 * 32 * A.visible_pairs(16, True, 5),
          4 * 2 * 2 * 16 * 6 * 32)),
        ("flash_attention_bwd",
         lambda: ops.flash_attention_bwd(q, k, v, o, lse, o, window=5),
         (10 * 2 * 4 * 32 * A.visible_pairs(16, True, 5),
          4 * 4 * 2 * 16 * 6 * 32 + 4 * 2 * 4 * 16)),
        ("decode_attention", lambda: ops.decode_attention(dq, kc, vc, pos),
         (4 * 4 * 32 * 3 * 10, 3 * 10 * 2 * 2 * 32 * 4 + 2 * 3 * 4 * 32 * 4
          + 4 * 3)),
        ("gmm_blocks", lambda: ops.gmm_blocks(gx, gw, gs),
         (2 * 3 * 8 * 16 * 12, 4 * (3 * 8 * 16 + 3 * 16 * 12 + 3 * 8 * 12)
          + 4 * 3)),
        ("gmm_blocks_dw", lambda: ops.gmm_blocks_dw(gx, gdy),
         (2 * 3 * 8 * 16 * 12, 4 * (3 * 8 * 16 + 3 * 8 * 12 + 3 * 16 * 12))),
        ("ssd_scan", lambda: ops.ssd_scan(sx, sdt, sA, sB, sC, sD, chunk=Q),
         (2 * B * nc * pairs * N
          + 2 * B * H * nc * (pairs * P + 2 * Q * N * P),
          4 * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + 2 * H)
          + 4 * B * H * P * N)),
        ("ssd_scan_bwd",
         lambda: ops.ssd_scan_bwd(sx, sdt, sA, sB, sC, sD, cum, cb, ins, y),
         (2 * B * nc * H * (4 * Q * N * P + 2 * pairs * P)
          + 4 * B * nc * pairs * N,
          4 * (3 * B * S * H * P + 4 * B * S * N)
          + 4 * (3 * B * S * H + 4 * H + B * nc * pairs)
          + 4 * B * nc * H * N * P + 4 * B * H * P * N)),
        ("dequant_int8", lambda: ops.dequant_int8(
            torch.from_numpy(q8), torch.from_numpy(s8)),
         (9 * 7, 9 * 7 + 4 * 7 + 4 * 9 * 7)),
        ("dequant_int4", lambda: ops.dequant_int4(
            torch.from_numpy(p4), torch.from_numpy(s4), 9),
         (9 * 7, 5 * 7 + 4 * 7 + 4 * 9 * 7)),
    ]


@pytest.mark.parametrize("i", range(10))
def test_wrapper_reports_its_cost_and_hides_its_plain_ops(i):
    """Each costed wrapper reports one call at the bound column's count
    (the FLOPs of the function, each input read once and each output
    written once), and its plain version's aten ops on the CPU are not
    counted."""
    name, call, (flops, nbytes) = _kernel_calls()[i]
    with torch.no_grad():
        cost = _count(call)
    assert cost.ops == 0
    assert cost.kernels == {name: [1, flops, nbytes]}
    assert (cost.flops, cost.hbm_bytes) == (flops, nbytes)


def test_wrapper_on_meta_returns_shapes_without_its_plain_version(
        monkeypatch):
    """On meta a wrapper checks its inputs, returns empty meta outputs of
    the kernel's shapes and dtypes, and reports its cost; it never runs
    its plain version nor loads a library."""
    from repro_torch.kernels import _native
    from repro_torch.kernels import matmul as MM

    def refuse(*a, **k):
        raise AssertionError("called on meta")

    monkeypatch.setattr(MM, "matmul_plain", refuse)
    monkeypatch.setattr(A, "flash_attention_plain", refuse)
    monkeypatch.setattr(_native, "library", refuse)
    x = torch.empty(6, 40, dtype=torch.bfloat16, device="meta")
    w = torch.empty(40, 24, dtype=torch.bfloat16, device="meta")
    with OpCounter() as c:
        y = ops.matmul(x, w)
        o = ops.flash_attention(*(torch.empty(
            1, 8, h, 16, dtype=torch.bfloat16, device="meta")
            for h in (4, 2, 2)))
    assert (y.device.type, tuple(y.shape), y.dtype) == (
        "meta", (6, 24), torch.bfloat16)
    assert (o.device.type, tuple(o.shape)) == ("meta", (1, 8, 4, 16))
    assert sorted(c.cost.kernels) == ["flash_attention", "matmul"]
    # the card's checks hold on meta: a strided x is refused
    with pytest.raises(ValueError):
        ops.matmul(torch.empty(40, 6, dtype=torch.bfloat16,
                               device="meta").T, w)
    with pytest.raises(TypeError):
        ops.matmul(x, w.to(torch.float32))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("name,call", [
    ("matmul_packed", lambda: ops.matmul_packed(
        _meta(4, 200), _meta(1, 2, 128, 128), K=200, N=100)),
    ("winograd_tile_matmul", lambda: ops.winograd_tile_matmul(
        _meta(16, 9, 8), _meta(16, 8, 5))),
    ("matmul_dequant_int8", lambda: ops.matmul_dequant_int8(
        _meta(4, 8), _meta(8, 16, dtype=torch.int8), _meta(1, 16))),
    ("matmul_dequant_int4", lambda: ops.matmul_dequant_int4(
        _meta(4, 8), _meta(4, 16, dtype=torch.uint8), _meta(1, 16), K=8)),
])
def test_wrappers_without_a_meta_branch_refuse_meta(monkeypatch, name, call):
    """Only the costed wrappers have a meta branch: the others refuse
    meta tensors as they refuse any device but the CPU and the card,
    before any build or launch."""
    from repro_torch.kernels import _native

    def refuse(*a, **k):
        raise AssertionError("reached a build")

    monkeypatch.setattr(_native, "library", refuse)
    with pytest.raises(ValueError, match=f"{name}: tensors must lie on the "
                       f"CPU or on one CUDA device"):
        call()


def test_cpu_wrapper_keeps_its_plain_layout_and_its_copy_is_free():
    """On the CPU a wrapper returns its plain version's result as it is
    (flash attention's is strided); the counter charges nothing for the
    copy that makes it contiguous, which the card (whose kernel writes it
    contiguous) never runs, so the count matches meta's."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, h, 16, generator=g) for h in (4, 2, 2))
    plain = A.flash_attention_plain(q, k, v)
    out = ops.flash_attention(q, k, v)
    assert out.stride() == plain.stride() and not out.is_contiguous()
    got = []
    for dev in ("cpu", "meta"):
        qd, kd, vd = (t.to(dev) for t in (q, k, v))
        with OpCounter() as c:
            ops.flash_attention(qd, kd, vd).reshape(1, 8, 64).sum()
        got.append((c.cost.totals(), c.cost.ops, c.cost.kernels))
    assert got[0] == got[1]
    # a copy of anything else still costs its bytes
    with OpCounter() as c:
        plain.reshape(1, 8, 64)
    assert (c.cost.ops, c.cost.hbm_bytes) == (1, 2 * plain.numel() * 4)


def _batch(cfg, B=2, S=16):
    g = torch.Generator().manual_seed(1)
    if cfg.input_mode == "embeddings":
        return {"embeds": torch.randn(B, S, cfg.d_model, generator=g),
                "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                        generator=g, dtype=torch.int32)}
    if cfg.input_mode == "vlm":
        P = cfg.num_prefix_embeds
        return {"tokens": torch.randint(0, cfg.vocab_size, (B, S - P),
                                        generator=g, dtype=torch.int32),
                "prefix_embeds": torch.randn(B, P, cfg.d_model, generator=g)}
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                    dtype=torch.int32)}


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "mamba2-2.7b", "zamba2-2.7b", "gemma2-27b",
                                  "musicgen-medium", "internvl2-76b"])
def test_reduced_model_counts_the_same_on_cpu_and_meta(arch):
    """The prefill step (``forward`` with the cache) and a two-microbatch
    train step count the same FLOPs, bytes, transcendentals and ops on
    the CPU as on meta."""
    cfg = get_config(arch).reduced(num_layers=4, ssm_chunk=8)
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg)
    got = []
    for dev in ("cpu", "meta"):
        p = tree_map(lambda t: t.detach().clone().to(dev), params)
        b = tree_map(lambda t: t.to(dev), batch)
        with torch.no_grad(), OpCounter() as c:
            T.forward(p, b, cfg, collect_cache=True)
        step = make_train_step(cfg, num_microbatches=2)
        mb = {k: v.reshape(2, 1, *v.shape[1:]) for k, v in b.items()}
        opt = adamw_init(p)
        with OpCounter() as c2:
            step(p, opt, mb)
        got.append((c.cost.totals(), c.cost.ops, c.cost.kernels,
                    c2.cost.totals(), c2.cost.ops, c2.cost.kernels))
    assert got[0] == got[1]
    assert got[0][0][0] > 0 and got[0][3][0] > got[0][0][0]


def test_tracked_arguments_count_in_the_peak():
    x = torch.ones(64, 64)
    with OpCounter() as c:
        c.track((x, x))
        out = torch.matmul(x, x)
    assert out.shape == (64, 64)
    assert c.cost.arg_bytes == 64 * 64 * 4
    assert c.cost.peak_bytes == 2 * 64 * 64 * 4
    assert c.cost.top_flops(1)[0][0] == "mm float32"
