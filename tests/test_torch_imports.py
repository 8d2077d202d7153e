"""The port stands alone: nothing under src/repro_torch/, nor chip_smoke.py,
imports jax or the reference package; chip_smoke.py refuses to run without
a card or without the repository around it; the kernel build needs nvcc."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_has_every_slice_module():
    pkg = ROOT / "src" / "repro_torch"
    for rel in ("core/posit.py", "core/seltables.py", "core/divider.py",
                "kernels/posit_div.py", "kernels/ops.py", "kernels/posit_flash_attn.py",
                "kernels/_build.py", "kernels/csrc/posit_srt.cuh",
                "kernels/csrc/posit_fused_div.cu", "kernels/csrc/posit_flash_attn.cu",
                "numerics/formats.py", "numerics/posit_ops.py", "models/config.py",
                "models/layers.py", "models/transformer.py", "configs/smollm_360m.py",
                "serve/engine.py", "kernels/csrc/posit_flash_bwd.cu", "optim/tree.py",
                "optim/adamw.py", "optim/schedule.py", "data/pipeline.py",
                "train/trainer.py", "train/checkpoint.py", "launch/train.py",
                "core/quire.py", "kernels/csrc/posit_softmax.cu", "configs/olmoe_1b_7b.py",
                "kernels/posit_cast.py", "kernels/csrc/posit_div.cu",
                "kernels/csrc/posit_cast.cu", "kernels/csrc/posit10_plans.inc",
                "numerics/quant.py", "core/goldens.py", "core/costmodel.py",
                "core/wide.py"):
        assert (pkg / rel).is_file(), rel


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_kernel_build_needs_nvcc(monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
