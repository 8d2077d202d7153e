"""Build the CUDA sources in ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``.  Libraries land in ``kernels/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the sources, so an
edited source rebuilds and a stale library is never loaded.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, and explicitly
``-ftz=false -prec-div=true -prec-sqrt=true``: the posit datapath needs
f32 subnormals kept (``posit_srt.cuh``), so ``--use_fast_math`` is never
used.  ``-Xptxas -v`` output (registers, shared memory, spills) is kept
beside each library as ``<lib>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("posit_fused_div", "posit_flash_attn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".inc"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (proc, tmp, lib, t0) or None
    when the library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=lib.stem, suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib, time.perf_counter()


def _finish(name: str, job) -> float:
    """Wait for one build; returns its seconds."""
    proc, tmp, lib, t0 = job
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return seconds


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Build the named sources, one ``nvcc`` each, all started together.
    Returns the seconds each build took (0 for one already built)."""
    jobs = {n: _start(n) for n in names}
    seconds, errors = {}, []
    for n, job in jobs.items():
        try:
            seconds[n] = 0.0 if job is None else _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def ptxas_log(name: str) -> str:
    """What ``-Xptxas -v`` reported for the built library ('' if unbuilt)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
