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
                "core/wide.py", "serve/emit.py", "data/tokenizer.py", "launch/serve.py",
                "models/rglru.py", "configs/recurrentgemma_2b.py",
                "kernels/csrc/flash_stage.cuh", "optim/grad_compress.py",
                "models/mamba2.py", "configs/mamba2_2p7b.py"):
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


def test_flash_sources_build_once_per_format(monkeypatch, tmp_path):
    """The flash sources become one library per posit format, posit64's in
    three parts, each built with its own -DPOSIT_MODEL_N (and
    -DPOSIT_MODEL_PART) and named by them, all nvcc runs started together;
    the other sources one library each.  A stand-in for nvcc records its
    arguments and writes the library."""
    import sys

    from repro_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'w').write(' '.join(sys.argv[1:]))\n"
                    "print('ptxas info    : Used 1 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    seconds = _build.build()
    assert set(seconds) == set(_build.LIBRARIES) and all(s > 0 for s in seconds.values())
    expected = 0
    for src in _build.SOURCES:
        formats = _build.MODEL_FORMATS if src in _build.PER_FORMAT else [None]
        for n in formats:
            parts = _build.FORMAT_PARTS.get(n, ("",))
            for i, part in enumerate(parts):
                name = src if n is None else _build.library(src, n, part)
                lib = _build._lib_path(name)
                assert lib.name.startswith(f"lib{name}-")
                cmd = lib.read_text().split()
                assert cmd[-1].endswith(f"csrc/{src}.cu")
                defines = [] if n is None else [f"-DPOSIT_MODEL_N={n}"]
                if part:
                    defines.append(f"-DPOSIT_MODEL_PART={i}")
                assert [a for a in cmd if a.startswith("-DPOSIT_MODEL")] == defines
                assert "registers" in _build.ptxas_log(name)
                expected += 1
    assert expected == len(_build.LIBRARIES) == 16
    assert [n for n in _build.LIBRARIES if n.startswith("posit_flash_bwd_p64")] == [
        "posit_flash_bwd_p64_r4", "posit_flash_bwd_p64_r2", "posit_flash_bwd_p64_r2cs"]
    names = {_build._lib_path(n).name for n in _build.LIBRARIES}
    assert len(names) == len(_build.LIBRARIES)
    assert _build.build() == dict.fromkeys(_build.LIBRARIES, 0.0)   # already built


_FIRST_EXP = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
import repro_torch  # noqa: F401
g = torch.Generator().manual_seed(0)
s = torch.matmul(torch.randn(4, 24, 16, generator=g), torch.randn(4, 16, 64, generator=g))
x = s - s.max(-1, keepdim=True).values
first = torch.exp(x)
sys.exit(0 if torch.equal(first, torch.exp(x)) else 1)
"""


def test_first_cpu_exp_after_import_matches_later_ones():
    """torch's first multi-threaded CPU exp of a process, after a product,
    has now and then returned a 2048-element chunk about 3e-5 off (in 1-5%
    of fresh processes on an 8-thread host);
    importing the port makes that call first, so a twin's first exp is
    every later one's bits.  Fresh processes, the flash scan's shapes."""
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_EXP, str(ROOT / "src")])
             for _ in range(8)]
    assert [p.wait(timeout=300) for p in procs] == [0] * 8
