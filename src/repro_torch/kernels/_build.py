"""Build the CUDA sources in ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), loaded with ``ctypes``.
The flash sources (K3-K8) become one library per posit format,
``<name>_p<n>``, built with ``-DPOSIT_MODEL_N=<n>``, and posit64's in three
parts, ``<name>_p64_<part>`` (``-DPOSIT_MODEL_PART``: radix 4, radix 2
non-redundant, radix 2 carry-save): each instantiates only those plans
(``posit::kLibraryPlan``) behind the same C entry points, so they build
side by side instead of one after another.
Libraries land in ``kernels/_build/`` (listed in ``.gitignore``) under a
name that carries a hash of the sources and of the flags, so an edited
source rebuilds and a stale library is never loaded.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("posit_fused_div", "posit_flash_attn", "posit_flash_bwd", "posit_softmax",
           "posit_div", "posit_cast")
PER_FORMAT = ("posit_flash_attn", "posit_flash_bwd")   # built once per format (and part)
MODEL_FORMATS = (8, 16, 32, 64)                          # posit::kModelPlan's formats
# the libraries of a format, by part (posit::kLibraryPart): posit64's radix-2
# rows unroll 62 two-word iterations, so its six datapaths build in three
# libraries; every other format is one
FORMAT_PARTS = {64: ("r4", "r2", "r2cs")}


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-ftz=false", "-prec-div=true", "-prec-sqrt=true",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def part_of(plan) -> str:
    """The part of its format's libraries that holds ``plan``'s kernels (''
    for a format built as one library): the mirror of
    ``posit::kLibraryPart``."""
    if plan.n not in FORMAT_PARTS:
        return ""
    return "r4" if plan.radix == 4 else "r2cs" if plan.redundant else "r2"


def library(source: str, n: int, part: str = "") -> str:
    """The name of ``source``'s library for posit format ``n`` (and
    ``part``, for a format built in parts)."""
    return f"{source}_p{n}" + (f"_{part}" if part else "")


def library_of(source: str, plan) -> str:
    """The library of ``source`` that holds ``plan``'s kernels."""
    return library(source, plan.n, part_of(plan))


def _libraries() -> Dict[str, Tuple[str, Tuple[str, ...]]]:
    """Library name -> (source, the nvcc flags it adds)."""
    libs = {}
    for src in SOURCES:
        if src not in PER_FORMAT:
            libs[src] = (src, ())
            continue
        for n in MODEL_FORMATS:
            parts = FORMAT_PARTS.get(n)
            if parts is None:
                libs[library(src, n)] = (src, (f"-DPOSIT_MODEL_N={n}",))
            for i, part in enumerate(parts or ()):
                libs[library(src, n, part)] = (src, (f"-DPOSIT_MODEL_N={n}",
                                                     f"-DPOSIT_MODEL_PART={i}"))
    return libs


LIBRARIES = _libraries()

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src, defines = LIBRARIES[name]
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".inc"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one library; returns (proc, tmp, lib, t0) or None
    when the library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    src, defines = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=lib.stem, suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *defines, "-o", tmp, str(CSRC / f"{src}.cu")]
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
        raise RuntimeError(f"nvcc failed for {name} ({LIBRARIES[name][0]}.cu):\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return seconds


def build(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, float]:
    """Build the named libraries, one ``nvcc`` each, all started together.
    Returns the seconds each build took (0 for one already built), each
    waited for on a thread of its own so that its time is its own."""
    jobs = {n: _start(n) for n in names}
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        waits = {n: pool.submit(_finish, n, job) for n, job in jobs.items() if job is not None}
    seconds, errors = {}, []
    for n in jobs:
        try:
            seconds[n] = waits[n].result() if n in waits else 0.0
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of :data:`LIBRARIES`), building it
    if needed."""
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
