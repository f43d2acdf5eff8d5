"""Build and load the CUDA kernels of paropt_torch at first use.

The sources in ``paropt_torch/csrc`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source, all started together, and linked into
ONE shared library with a plain C interface, loaded with ``ctypes``.  The
library goes to ``build/paropt_torch_kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so a changed source
builds anew and an unchanged one is built once.  A failed build raises
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argtypes (every pointer and the stream c_void_p)
_SIGNATURES = {
    **{f"paropt_qn_roll_update_{sfx}": [_P] * 7 + [_I, _L, _I, _P]
       for sfx in ("f32", "f64", "bf16")},
    **{f"paropt_qn_roll_update_batched_{sfx}": [_P] * 7 + [_I, _L, _I, _I]
       + [_L] * 4 + [_P] for sfx in ("f32", "f64", "bf16")},
    **{f"paropt_quasi_def_apply_{sfx}": [_P] * 7 + [_I, _I, _L, _I, _P]
       for sfx in ("f32", "f64")},
    **{f"paropt_quasi_def_apply_batched_{sfx}": [_P] * 7
       + [_I, _I, _L, _I, _I] + [_L] * 5 + [_P] for sfx in ("f32", "f64")},
    **{f"paropt_phi_gram_{sfx}": [_P] * 10 + [_I, _I, _I, _L] + [_I] * 6
       + [_P] for sfx in ("f32", "f64")},
    **{f"paropt_phi_gram_batched_{sfx}": [_P] * 10 + [_I, _I, _I, _L]
       + [_I] * 8 + [_L] * 6 + [_P] for sfx in ("f32", "f64")},
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
    nvcc = _find_nvcc()
    tag = f"{os.getpid()}.tmp"
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    objs = [out_dir / f"{src.stem}.{tag}.o"
            for src in sorted(CSRC.glob("*.cu"))]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sorted(CSRC.glob("*.cu")), objs)]
    cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *(str(o) for o in objs)])
    t0 = time.perf_counter()
    log = []
    # every source at once, then the link
    for group in (cmds[:-1], cmds[-1:]):
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in group]
        for cmd, proc in zip(group, procs):
            out, err = proc.communicate()
            log.append(out + err)
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}\n"
                    f"command: {' '.join(cmd)}\n{out}{err}")
    build_seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text("".join(log))
    for obj in objs:
        obj.unlink()
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
