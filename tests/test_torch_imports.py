"""The port stands alone: no file under src/repro_torch/, and not
chip_smoke.py, imports jax, jaxlib, ml_dtypes or the JAX package (repro);
and the smoke script reports nothing where it cannot run."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for must in ("src/repro_torch/core/engine.py",
                 "src/repro_torch/kernels/matmul.py",
                 "src/repro_torch/kernels/conv_winograd.py",
                 "src/repro_torch/kernels/attention.py",
                 "src/repro_torch/kernels/quant.py",
                 "src/repro_torch/core/llm_graph.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/models/runtime_flags.py",
                 "src/repro_torch/serving/server.py",
                 "src/repro_torch/executor/server.py",
                 "src/repro_torch/executor/llm_bridge.py",
                 "src/repro_torch/kernels/gmm.py",
                 "src/repro_torch/kernels/ssd.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/models/sharding.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/specs.py",
                 "src/repro_torch/launch/presets.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/roofline/__init__.py",
                 "src/repro_torch/roofline/op_cost.py",
                 "src/repro_torch/roofline/analysis.py",
                 "chip_smoke.py"):
        assert must in names


def test_chip_smoke_prints_no_result_without_a_card(tmp_path):
    """Without a CUDA device, or without the repository beside it, the smoke
    script exits non-zero and prints no result line."""
    import shutil
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the smoke run would start")
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
