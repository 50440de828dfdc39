"""Builds the CUDA sources under ``csrc/`` and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``_build/lib<name>_<hash>.so``, compiled by ``nvcc`` for ``sm_90a`` at first
use. All sources are compiled together, one ``nvcc`` process each, and the
hash covers every source and the flags, so an edited source is rebuilt. A
failed build raises with ``nvcc``'s output; there is no other route to the
kernels.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# no --use_fast_math, and no FMA contraction: every operation stays the IEEE
# f32 operation that the plain PyTorch versions perform one by one
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
build_info = {"seconds": None, "log": "", "nvcc": None}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, the PATH, or /usr/local/cuda/bin."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, the PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that has no library for the current hash, all
    nvcc processes started together. Returns {name: library path}."""
    key = _key()
    paths = {src.stem: BUILD_DIR / f"lib{src.stem}_{key}.so" for src in _sources()}
    todo = [src for src in _sources() if not paths[src.stem].exists()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = BUILD_DIR / f"lib{src.stem}_{key}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed, log = [], []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        log.append(f"--- {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
        else:
            os.replace(tmp, paths[src.stem])
    build_info.update(seconds=time.perf_counter() - t0, log="\n".join(log), nvcc=nvcc)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if need be."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all()[name]))
    return _libs[name]
