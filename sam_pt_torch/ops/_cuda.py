"""Build and load the port's CUDA kernels.

Every `*.cu` file under `sam_pt_torch/csrc/` is compiled by `nvcc` for
Hopper (`sm_90a`) into ONE shared library with a plain C interface, which
is loaded with `ctypes`. No PyTorch header is included, so a build takes
seconds. The library goes to `build/kernels-<hash>/` at the repository
root, keyed by a hash of the sources and flags, and is built at first use
(never at import). `nvcc` is looked up on PATH, then under `$CUDA_HOME`
and `/usr/local/cuda`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB = None
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (see the .cu sources for meanings)
_SIGNATURES = {
    "sam_window_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sam_global_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sam_cross_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256()
    for path in sources + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"
    lib_path = out_dir / "libsam_pt_kernels.so"
    t0 = time.perf_counter()
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sources]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_INFO["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{BUILD_INFO['log']}")
        os.replace(tmp, lib_path)
        BUILD_INFO["built"] = True
    else:
        BUILD_INFO["built"] = False
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
