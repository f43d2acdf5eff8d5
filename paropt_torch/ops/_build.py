"""Build and load the CUDA kernels of paropt_torch at first use.

The sources in ``paropt_torch/csrc`` are compiled by ``nvcc`` for Hopper
(``sm_90a``) into ONE shared library with a plain C interface, loaded with
``ctypes``.  The library goes to ``build/paropt_torch_kernels/<hash>/`` at the
root of the checkout, keyed by a hash of the sources and flags, so a changed
source builds anew and an unchanged one is built once.  A failed build raises
with nvcc's output in the message.

Nothing here runs at import: the first kernel launch calls `load_library`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "build_library", "source_hash"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "paropt_torch_kernels")
LIB_NAME = "libparopt_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every pointer and the stream c_void_p)
_SIGNATURES = {
    **{f"paropt_qn_roll_update_{sfx}": [_P] * 7 + [_I, _L, _I, _P]
       for sfx in ("f32", "f64", "bf16")},
    **{f"paropt_quasi_def_apply_{sfx}": [_P] * 7 + [_I, _I, _L, _P]
       for sfx in ("f32", "f64")},
    **{f"paropt_phi_gram_{sfx}": [_P] * 9 + [_I, _I, _L, _I, _I, _P]
       for sfx in ("f32", "f64")},
    "paropt_qn_roll_tile": [],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the paropt_torch CUDA kernels cannot be built")


def build_library() -> Path:
    """Compile the sources if this hash has no library yet; return its path.
    The compiler's resource report (``-Xptxas -v``) is kept in
    ``build.log`` beside the library."""
    global build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}\n"
            f"command: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build just writes it twice
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with the argtypes
    of every entry point set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib
