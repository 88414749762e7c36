"""``plan_ssd_bwd``, the host planner of the ``ssd_scan_bwd`` kernels
(``csrc/ssd_bwd.cu``), on the CPU: its cut frozen at the shapes
``chip_smoke.py`` checks on the card, the chunk kernel's grid against the
132 SMs of an H100, its shared memory against a block's, its group of
heads as the fewest that keep the grid within two waves, and that it
reads shapes only and refuses what the kernels refuse. No tolerance: these are integers."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd as SSD  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32

# (B, S, H, P, N, Q, dtype) -> (heads, groups, blocks of the five kernels,
# the chunk kernel's shared memory): mamba2-2.7b's training microbatch in
# bf16 and f32, zamba2-2.7b's (N 64), mamba2 at S 1024, and the ragged
# rows (35 heads in groups of 2; a 320-token chunk, one row tile of dCB
# terms past the four a block holds, in bf16 and f32)
FROZEN = {
    (4, 512, 80, 64, 128, 256, BF16): (10, 8, (1280, 1280, 256, 128, 80),
                                       221696),
    (4, 512, 80, 64, 128, 256, F32): (10, 8, (1280, 1280, 256, 128, 80),
                                      216064),
    (4, 512, 80, 64, 64, 256, BF16): (10, 8, (640, 640, 256, 64, 80),
                                      221696),
    (1, 1024, 80, 64, 128, 256, BF16): (5, 16, (640, 320, 256, 64, 80),
                                        221696),
    (1, 400, 35, 48, 96, 200, BF16): (2, 18, (140, 105, 144, 32, 35),
                                      220576),
    (1, 640, 6, 40, 72, 320, BF16): (1, 6, (24, 18, 60, 40, 6), 222976),
    (1, 640, 6, 40, 72, 320, F32): (1, 6, (24, 18, 60, 40, 6), 216832),
}


@pytest.mark.parametrize("shape", list(FROZEN))
def test_plan_ssd_bwd_frozen(shape):
    p = SSD.plan_ssd_bwd(*shape)
    assert (p.heads, p.groups, p.blocks, p.smem) == FROZEN[shape]
    B, S, H, P, N, Q, _ = shape
    assert p.groups == -(-H // p.heads)
    assert p.smem <= SSD.SSD_BWD_MAX_SMEM


def test_plan_ssd_bwd_fills_the_card_and_bounds_the_scratch():
    """At mamba2-2.7b's training microbatch the chunk kernel's blocks (one
    an SM: its shared memory) fill the 132 SMs, in two waves less 8
    blocks; the scratch stays below 100 MB (the per-head design before it
    took ~358 MB). The ragged row's 35 heads are no multiple of its
    group."""
    for dt in (BF16, F32):
        p = SSD.plan_ssd_bwd(4, 512, 80, 64, 128, 256, dt)
        assert 132 <= p.blocks[2] <= 2 * 132
        assert 2 * p.smem > SSD.SSD_BWD_MAX_SMEM   # one block an SM
        assert p.scratch < 100e6
    ragged = SSD.plan_ssd_bwd(1, 400, 35, 48, 96, 200, BF16)
    assert 35 % ragged.heads != 0


@pytest.mark.parametrize("shape", [(4, 512, 80, 256), (1, 1024, 80, 256),
                                   (1, 400, 35, 200), (4, 512, 8, 256),
                                   (8, 2048, 80, 256), (2, 384, 24, 128)])
def test_plan_ssd_bwd_takes_the_fewest_heads_within_two_waves(shape):
    """The chunk kernel's grid, (b, chunk, row tile, group), is at most two
    waves of the 132 SMs, and one head fewer a block would pass them;
    where even one group a tile passes two waves, the group is every
    head."""
    B, S, H, Q = shape
    p = SSD.plan_ssd_bwd(B, S, H, 64, 128, Q, BF16)
    per_group = B * (S // Q) * -(-Q // 64)
    assert p.blocks[2] == per_group * p.groups
    if per_group > 2 * 132:
        assert p.heads == H
    else:
        assert p.blocks[2] <= 2 * 132
        assert p.heads == 1 or per_group * -(-H // (p.heads - 1)) > 2 * 132


def test_plan_ssd_bwd_reads_shapes_only_and_refuses():
    a = SSD.plan_ssd_bwd(4, 512, 80, 64, 128, 256, BF16)
    assert SSD.plan_ssd_bwd(4, 512, 80, 64, 128, 256, BF16) is a
    for bad in [(1, 256, 8, 65, 64, 64), (1, 256, 8, 64, 129, 64),
                (1, 250, 8, 64, 64, 64), (1, 4096, 8, 64, 64, 4096)]:
        with pytest.raises(ValueError):
            SSD.plan_ssd_bwd(*bad)


def test_ssd_bwd_plan_takes_any_group():
    """The A/B's variants: any group of heads, clamped to H; more heads a
    block, fewer groups and less scratch."""
    shape, heads = (4, 512, 80, 64, 128, 256, BF16), (2, 4, 5, 8, 9, 10, 16)
    plans = [SSD.ssd_bwd_plan(*shape, h) for h in heads]
    assert [p.groups for p in plans] == [-(-80 // h) for h in heads]
    assert all(a.scratch > b.scratch for a, b in zip(plans, plans[1:]))
    assert SSD.ssd_bwd_plan(*shape, 500).heads == 80
