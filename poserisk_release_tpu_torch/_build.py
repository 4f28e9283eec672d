"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with nvcc into a shared library with a plain C
interface, which ctypes loads: no PyTorch headers are compiled, so a build
takes seconds. Libraries go to `_build/` next to this file (listed in
.gitignore), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. Nothing here runs at import
time: the CPU-only tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_PKG_DIR = osp.dirname(osp.abspath(__file__))
CSRC_DIR = osp.join(_PKG_DIR, "csrc")
BUILD_DIR = osp.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (osp.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and osp.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are compiled from csrc/ at first use")


def library_path(name: str) -> str:
    with open(osp.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return osp.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (process, tmp_path, final_path) or None. The library is written to a
    temporary name and renamed into place, so a concurrent or interrupted
    build never leaves a half-written file under the final name."""
    out = library_path(name)
    if osp.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, osp.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def build(names: Iterable[str]) -> None:
    """Compile every named kernel source, all nvcc processes started
    together; raises with nvcc's output if any build fails."""
    jobs = [(n, _start_build(n)) for n in names]
    errors = []
    for name, job in jobs:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(library_path(name))
    return lib
