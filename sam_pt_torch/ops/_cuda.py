"""Build and load the port's CUDA kernels.

Every `*.cu` file under `sam_pt_torch/csrc/` is compiled by its own `nvcc`
for Hopper (`sm_90a`), all of them at once, and the objects are linked
into ONE shared library with a plain C interface, which is loaded with
`ctypes`. No PyTorch header is included, so a build takes seconds. The
library goes to `build/kernels-<hash>/` at the repository root, keyed by
a hash of the sources and flags, and is built at first use (never at
import). `nvcc` is looked up on PATH, then under `$CUDA_HOME` and
`/usr/local/cuda`.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIB = None
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argtypes (see the .cu sources for meanings)
_SIGNATURES = {
    "sam_window_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sam_global_attention": [_P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "sam_cross_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                            _P],
    "sam_relpos_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                             _P],
    "sam_layer_norm": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _F,
                       _I, _I, _P],
    "sam_window_blocks_per_sm": [_I, _I, _I],
    "sam_flash_blocks_per_sm": [_I, _I, _I],
    "sam_cross_i2t_blocks_per_sm": [_I, _I, _I],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build(sources, out_dir: Path, lib_path: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    tag = os.getpid()
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = out_dir / f"lib.{tag}.so"
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    BUILD_INFO["log"] = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           f"{BUILD_INFO['log']}")
    os.replace(tmp, lib_path)


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
        _build(sources, out_dir, lib_path)
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
