"""The port's dry run (``launch.dryrun``): steps built and counted on meta
tensors at full width on one card's (1, 1) mesh, the report's fields
present and consistent, the launcher's exit codes, the table arithmetic
of the reference's meshes, and ``build_step`` on the CPU counting what it
counts on meta. Nothing here draws a full-width weight.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

torch.set_num_threads(1)

FIELDS = {"arch", "shape", "mesh", "chips", "flops_per_device",
          "hbm_bytes_per_device", "wire_bytes_per_device", "compute_s",
          "memory_s", "collective_s", "bottleneck", "model_flops",
          "useful_flops_ratio", "peak_memory_bytes", "collective_by_kind",
          "flashable_hbm_bytes", "memory_s_flash", "arg_bytes", "out_bytes",
          "alias_bytes", "temp_bytes", "fits_hbm", "microbatches",
          "kernels"}
GONE = {"cpu_f32_artifact_bytes", "peak_tpu_bytes", "fits_hbm_raw_cpu"}


@pytest.mark.parametrize("arch,shape,micro,kernels", [
    ("smollm-360m", "prefill_32k", None, {"matmul", "flash_attention"}),
    ("mamba2-2.7b", "decode_32k", None, {"matmul"}),
    ("zamba2-2.7b", "long_500k", None, {"matmul", "decode_attention"}),
    ("granite-moe-3b-a800m", "train_4k", 2,
     {"matmul", "flash_attention", "flash_attention_bwd", "gmm_blocks",
      "gmm_blocks_dw"}),
])
def test_run_one_on_meta(arch, shape, micro, kernels):
    r = dryrun.run_one(arch, shape, microbatches=micro, verbose=False)
    assert FIELDS <= set(r) and not GONE & set(r)
    assert (r["mesh"], r["chips"]) == ("1x1", 1)
    assert r["microbatches"] == (micro or 1)
    assert r["fits_hbm"] == (r["peak_memory_bytes"] <= M.HBM_PER_CHIP)
    terms = {k: r[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert r["bottleneck"] == max(terms, key=terms.get)
    assert r["collective_s"] == r["wire_bytes_per_device"] == 0
    assert r["compute_s"] == r["flops_per_device"] / M.PEAK_FLOPS_BF16
    assert r["memory_s"] == r["hbm_bytes_per_device"] / M.HBM_BW
    assert 0 < r["model_flops"] <= r["flops_per_device"]
    assert r["useful_flops_ratio"] == pytest.approx(
        r["model_flops"] / r["flops_per_device"])
    assert r["peak_memory_bytes"] >= r["arg_bytes"] > 0
    assert r["peak_memory_bytes"] == pytest.approx(
        r["arg_bytes"] + r["out_bytes"] - r["alias_bytes"]
        + r["temp_bytes"])
    assert kernels <= set(r["kernels"])


def test_prefill_logits_alone_exceed_one_card():
    """smollm-360m's prefill_32k builds the full (32, 32768, 49152) f32
    logits before taking the last position: more than 80 GB."""
    r = dryrun.run_one("smollm-360m", "prefill_32k", verbose=False)
    assert not r["fits_hbm"]
    assert r["peak_memory_bytes"] > 32 * 32768 * 49152 * 4


def test_main_writes_results_and_exits_zero(tmp_path, capsys):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                 "--out", str(out)])
    got = json.loads(out.read_text())
    assert len(got["results"]) == 1 and got["failures"] == []
    assert "1 ok, 0 failed" in capsys.readouterr().out


def test_main_exits_non_zero_on_a_failure(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise RuntimeError("broken step")

    monkeypatch.setattr(dryrun, "run_one", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                     "--out", str(tmp_path / "x.json")])
    assert e.value.code == 1


@pytest.mark.parametrize("multi_pod", [False, True])
def test_table_arithmetic_on_the_reference_meshes(multi_pod):
    r = dryrun.table_bytes("mamba2-2.7b", "decode_32k", multi_pod=multi_pod,
                           verbose=False)
    assert r["mesh"] == ("2x16x16" if multi_pod else "16x16")
    assert r["chips"] == (512 if multi_pod else 256)
    assert r["kind"].startswith("table arithmetic")
    assert r["total_bytes"] == (r["params_bytes"] + r["cache_bytes"]
                                + r["batch_bytes"])
    assert "temp_bytes" not in r and "compute_s" not in r


def test_microbatch_halving_loop():
    """The presets' microbatches halve until a microbatch splits over the
    data axes (train_4k: 256 sequences)."""
    sc = ShapeConfig("train_4k", 4096, 256, "train")
    pod = M.make_production_mesh(multi_pod=True)
    assert dryrun._microbatches("internvl2-76b", sc, pod, None) == 8
    assert dryrun._microbatches("internvl2-76b", sc, dryrun.ONE_CARD,
                                None) == 32
    assert dryrun._microbatches("smollm-360m", sc, pod, 3) == 1


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_step_on_the_cpu_counts_what_meta_counts(kind):
    """The same step on the CPU (weights drawn from a seed) and on meta:
    the same FLOPs, bytes and ops."""
    sc = ShapeConfig(f"small_{kind}", 16, 2, kind)
    over = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=256,
                num_heads=4, num_kv_heads=2, head_dim=32)
    got = []
    for dev in ("cpu", "meta"):
        step = dryrun.build_step("smollm-360m", sc, device=dev,
                                 microbatches=2, cfg_overrides=over)
        out, cost, *_ = dryrun.count_step(step)
        got.append((cost.totals(), cost.ops, cost.kernels))
    assert got[0] == got[1]
    if kind == "prefill":
        logits, cache = out
        assert tuple(logits.shape) == (2, 256)
        assert tuple(cache["kv"][0].shape) == (2, 2, 16, 2, 32)
