"""Build the hand-written CUDA kernels from ``csrc/`` and load them.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, which ``ops.py`` binds with ``ctypes``.
No PyTorch headers are involved, so a build takes seconds.  Libraries
land in ``build/torch_ext/`` at the root of the checkout (git ignores
it), named by a digest of their source and flags, so an edited source is
rebuilt and an unchanged one is reused.  A failed build raises; there is
no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
KERNELS = ("gaia_select", "neighbor_mix", "rand_k_select", "dgc_topk",
           "group_norm", "flash_attention")
#: no --use_fast_math: the histogram's bins need IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc of the CUDA toolkit: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns ``{name: compiler
    output}`` for the kernels built now (ptxas' register and spill
    report); raises ``RuntimeError`` with the compiler output if any
    build fails."""
    names = list(names)
    unknown = sorted(set(names) - set(KERNELS))
    if unknown:
        raise ValueError(f"unknown kernels {unknown}; known: {KERNELS}")
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n in todo:
            tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = {}, []
        for n, (tmp, p) in procs.items():
            logs[n] = p.communicate()[0]
            if p.returncode != 0:
                failed.append(n)
            else:
                os.replace(tmp, library_path(n))
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def load_built() -> None:
    """Load every kernel's library, built beforehand (by another process:
    a training rank loads what its parent built rather than compiling a
    copy beside the others); raises ``RuntimeError`` where one is
    missing."""
    missing = [n for n in KERNELS if not library_path(n).exists()]
    if missing:
        raise RuntimeError(f"kernel libraries not built: {missing}; run "
                           "kernels.build.build() before starting the ranks")
    for n in KERNELS:
        load(n)
