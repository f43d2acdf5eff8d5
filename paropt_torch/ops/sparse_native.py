"""ctypes binding of the native sparse Cholesky (counterpart of
paropt_tpu/ops/sparse_native.py, whose classes it copies).

The general-CSR constraint path factors the Schur complement
Cw = C0 + Aw·D⁻¹·Awᵀ, which is not block diagonal there, on the host: a
fill-reducing ordering (minimum degree, nested dissection, or the better of
the two by symbolic fill) and a supernodal or simplicial sparse Cholesky,
all in the plain C++ source ``src_native/paropt_sparse.cpp`` at the root of
the repository.  This is a host library in both packages, not a device
kernel: the reference's ``ParOptQuasiDefSparseMat`` is serial per process
too.

The source is compiled at first use, never at import, with
``g++ -O3 -fPIC -shared -std=c++17`` into
``build/paropt_torch_sparse/<hash>/``, keyed by a hash of the source and the
flags, so a changed source builds anew.  A failed build raises with g++'s
output; there is no Python factorization to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["SparseCholesky", "CSRQuasiDefMat", "csr_adat", "amd_order",
           "nd_order", "fill_count", "load_library", "build_library"]

SOURCE = (Path(__file__).resolve().parents[2] / "src_native"
          / "paropt_sparse.cpp")
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "paropt_torch_sparse")
LIB_NAME = "libparopt_torch_sparse.so"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_DP = ctypes.POINTER(ctypes.c_double)
_H = ctypes.c_void_p
# C entry point -> (restype, argtypes)
_SIGNATURES = {
    "paropt_amd_order": (_I, [_I, _IP, _IP, _IP]),
    "paropt_nd_order": (_I, [_I, _IP, _IP, _IP]),
    "paropt_fill_count": (ctypes.c_longlong, [_I, _IP, _IP, _IP]),
    "paropt_chol_create": (_H, [_I, _IP, _IP, _I]),
    "paropt_chol_nnz": (_I, [_H]),
    "paropt_chol_factor": (_I, [_H, _DP]),
    "paropt_chol_solve": (_I, [_H, _DP, _I]),
    "paropt_chol_destroy": (None, [_H]),
    "paropt_snchol_create": (_H, [_I, _IP, _IP, _I]),
    "paropt_snchol_nnz": (_I, [_H]),
    "paropt_snchol_nsuper": (_I, [_H]),
    "paropt_snchol_factor": (_I, [_H, _DP]),
    "paropt_snchol_solve": (_I, [_H, _DP, _I]),
    "paropt_snchol_destroy": (None, [_H]),
    "paropt_adat_symbolic": (_I, [_I, _I, _IP, _IP, _IP, _IP]),
    "paropt_adat_numeric": (_I, [_I, _I, _IP, _IP, _DP, _DP, _DP, _IP, _IP,
                                 _DP]),
}

_lock = threading.Lock()
_lib = None


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the source if this hash has no library yet; return its
    path.  Raises RuntimeError with the compiler's output on failure."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("g++ not found: the native sparse Cholesky "
                           f"cannot be built ({exc})") from exc
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed with exit code {proc.returncode}\n"
            f"command: {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build just writes it twice
    return lib


def load_library() -> ctypes.CDLL:
    """The native library, built on first use, with every signature set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def _iptr(a):
    return a.ctypes.data_as(_IP)


def _dptr(a):
    return a.ctypes.data_as(_DP)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _order(name: str, rowp, cols) -> np.ndarray:
    lib = load_library()
    rowp, cols = _i32(rowp), _i32(cols)
    n = rowp.shape[0] - 1
    perm = np.zeros(n, dtype=np.int32)
    if getattr(lib, f"paropt_{name}_order")(n, _iptr(rowp), _iptr(cols),
                                             _iptr(perm)) != 0:
        raise RuntimeError(f"{name} ordering failed")
    return perm


def amd_order(rowp, cols) -> np.ndarray:
    """Minimum-degree fill-reducing ordering: perm[old] = new position."""
    return _order("amd", rowp, cols)


def nd_order(rowp, cols) -> np.ndarray:
    """Nested-dissection fill-reducing ordering: perm[old] = new
    position."""
    return _order("nd", rowp, cols)


def fill_count(rowp, cols, perm) -> int:
    """Symbolic nnz(L), the diagonal included, for a candidate ordering."""
    lib = load_library()
    rowp, cols, perm = _i32(rowp), _i32(cols), _i32(perm)
    return int(lib.paropt_fill_count(rowp.shape[0] - 1, _iptr(rowp),
                                     _iptr(cols), _iptr(perm)))


class SparseCholesky:
    """L·Lᵀ = P·A·Pᵀ of a symmetric positive-definite CSR matrix
    (``ParOptSparseCholesky``'s role): ``factor(values)`` then
    ``solve(b)``, with the ``natural``, ``amd``, ``nd`` or ``auto`` (AMD or
    ND, whichever fills less) ordering and the ``supernodal`` (dense column
    panels, rank-ns updates) or ``simplicial`` (column by column) method."""

    _ORDERINGS = {"natural": 0, "amd": 1, "nd": 2, "auto": 3}

    def __init__(self, rowp, cols, ordering: str = "amd",
                 method: str = "supernodal"):
        self._lib = load_library()
        self.rowp, self.cols = _i32(rowp), _i32(cols)
        self.n = self.rowp.shape[0] - 1
        self.method = method
        if ordering not in self._ORDERINGS:
            raise ValueError(
                f"ordering must be one of {sorted(self._ORDERINGS)}, "
                f"got {ordering!r}")
        self._h = self._sym("create")(self.n, _iptr(self.rowp),
                                      _iptr(self.cols),
                                      self._ORDERINGS[ordering])
        if not self._h:
            raise RuntimeError("sparse cholesky symbolic analysis failed")

    def _sym(self, name):
        pre = ("paropt_snchol_" if self.method == "supernodal"
               else "paropt_chol_")
        return getattr(self._lib, pre + name)

    @property
    def nnz(self) -> int:
        return int(self._sym("nnz")(self._h))

    @property
    def nsupernodes(self) -> int:
        """Number of supernodes (n for the simplicial method)."""
        if self.method == "supernodal":
            return int(self._lib.paropt_snchol_nsuper(self._h))
        return self.n

    def factor(self, values) -> None:
        values = np.ascontiguousarray(values, dtype=np.float64)
        rc = self._sym("factor")(self._h, _dptr(values))
        if rc != 0:
            raise RuntimeError(
                f"sparse Cholesky failed: not positive definite at "
                f"column {rc - 1}")

    def solve(self, b) -> np.ndarray:
        """A⁻¹ b for b [n] or [n, nrhs] (a Fortran-ordered copy)."""
        b = np.array(b, dtype=np.float64, order="F", copy=True)
        nrhs = 1 if b.ndim == 1 else b.shape[1]
        if self._sym("solve")(self._h, _dptr(b), nrhs) != 0:
            raise RuntimeError("sparse solve failed")
        return b

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._sym("destroy")(self._h)
                self._h = None
        except Exception:
            pass


def csr_adat(rowp, cols, vals, dvec, cdiag=None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rowp, cols, vals) of C + A·diag(d)·Aᵀ for CSR A [m, n], C =
    diag(cdiag) or 0."""
    lib = load_library()
    rowp, cols = _i32(rowp), _i32(cols)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    dvec = np.ascontiguousarray(dvec, dtype=np.float64)
    m, n = rowp.shape[0] - 1, dvec.shape[0]
    out_rowp = np.zeros(m + 1, dtype=np.int32)
    lib.paropt_adat_symbolic(m, n, _iptr(rowp), _iptr(cols), _iptr(out_rowp),
                             ctypes.cast(None, _IP))
    out_cols = np.zeros(out_rowp[m], dtype=np.int32)
    lib.paropt_adat_symbolic(m, n, _iptr(rowp), _iptr(cols), _iptr(out_rowp),
                             _iptr(out_cols))
    out_vals = np.zeros(out_rowp[m], dtype=np.float64)
    if cdiag is not None:
        cdiag = np.ascontiguousarray(cdiag, dtype=np.float64)
        cd = _dptr(cdiag)
    else:
        cd = ctypes.cast(None, _DP)
    lib.paropt_adat_numeric(m, n, _iptr(rowp), _iptr(cols), _dptr(vals),
                            _dptr(dvec), cd, _iptr(out_rowp),
                            _iptr(out_cols), _dptr(out_vals))
    return out_rowp, out_cols, out_vals


class CSRQuasiDefMat:
    """General-CSR quasi-definite matrix [[D, -Awᵀ], [Aw, C0]] factored
    through Cw = C0 + Aw·D⁻¹·Awᵀ with the sparse Cholesky
    (``ParOptQuasiDefSparseMat``'s role).

    A variable that appears in at least max(16, ``dense_col_fraction`` ·
    nwcon) rows would fill Cw almost completely: such dense columns are
    left out of the sparse product and applied as a low-rank
    Sherman–Morrison–Woodbury correction at solve time.  ``nfactor``,
    ``factor_seconds`` and ``solve_seconds`` count the factorizations and
    the host time spent in them and in the solves."""

    def __init__(self, nvars: int, rowp, cols, ordering: str = "auto",
                 method: str = "supernodal",
                 dense_col_fraction: float = 0.25):
        self.nvars = int(nvars)
        self.rowp, self.cols = _i32(rowp), _i32(cols)
        self.nwcon = self.rowp.shape[0] - 1
        self._ordering = ordering
        self._method = method
        self._vals = np.zeros(self.rowp[-1])
        self._chol: Optional[SparseCholesky] = None
        self._pattern: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.nfactor = 0
        self.factor_seconds = 0.0
        self.solve_seconds = 0.0

        self._rows = np.repeat(np.arange(self.nwcon), np.diff(self.rowp))
        counts = np.zeros(self.nvars, dtype=np.int64)
        np.add.at(counts, self.cols, 1)
        thresh = max(16, int(dense_col_fraction * max(self.nwcon, 1)))
        self.dense_cols = np.nonzero(counts >= thresh)[0].astype(np.int32)
        self._col_is_dense = np.zeros(self.nvars, dtype=bool)
        self._col_is_dense[self.dense_cols] = True
        if self.dense_cols.size:
            keep = ~self._col_is_dense[self.cols]
            # the sparse remainder: the same rows, dense columns gone
            kept = np.bincount(self._rows[keep], minlength=self.nwcon)
            self._s_keep = keep
            self._s_rowp = np.concatenate([[0], np.cumsum(kept)]).astype(
                np.int32)
            self._s_cols = self.cols[keep]
            self._dense_pos = np.full(self.nvars, -1, dtype=np.int64)
            self._dense_pos[self.dense_cols] = np.arange(self.dense_cols.size)
        self._smw = None  # (U, V, S) of the last factorization

    def set_values(self, vals) -> None:
        """Install the current CSR Jacobian values."""
        self._vals = np.ascontiguousarray(vals, dtype=np.float64)

    def factor(self, Dinv, C0) -> None:
        t0 = time.perf_counter()
        Dinv = np.asarray(Dinv, dtype=np.float64)
        C0 = np.asarray(C0, dtype=np.float64)
        if self.dense_cols.size:
            rowp, cols = self._s_rowp, self._s_cols
            vals = self._vals[self._s_keep]
        else:
            rowp, cols, vals = self.rowp, self.cols, self._vals
        orp, oc, ov = csr_adat(rowp, cols, vals, Dinv, C0)
        if (self._pattern is None or len(oc) != len(self._pattern[1])
                or not np.array_equal(orp, self._pattern[0])):
            self._chol = SparseCholesky(orp, oc, ordering=self._ordering,
                                        method=self._method)
            self._pattern = (orp, oc)
        self._chol.factor(ov)
        if self.dense_cols.size:
            # U = Ad·diag(sqrt(Dinv_d)), so Cw = Cw_sparse + U·Uᵀ; the k×k
            # capacitance S = I + Uᵀ·Cw_sparse⁻¹·U serves the SMW solves
            k = self.dense_cols.size
            U = np.zeros((self.nwcon, k))
            dense = self._col_is_dense[self.cols]
            c = self.cols[dense]
            U[self._rows[dense], self._dense_pos[c]] = (self._vals[dense]
                                                  * np.sqrt(Dinv[c]))
            V = self._chol.solve(np.asfortranarray(U))
            self._smw = (U, V, np.eye(k) + U.T @ V)
        else:
            self._smw = None
        self.nfactor += 1
        self.factor_seconds += time.perf_counter() - t0

    def solve(self, b) -> np.ndarray:
        t0 = time.perf_counter()
        y = self._chol.solve(b)
        if self._smw is not None:
            U, V, S = self._smw
            y = y - V @ np.linalg.solve(S, U.T @ y)
        self.solve_seconds += time.perf_counter() - t0
        return y

    def get_factor_info(self) -> str:
        """Fill-in statistics (``getFactorInfo``)."""
        if self._chol is None:
            return "unfactored"
        nnz_a = int(self._pattern[0][-1])
        nnz_l = self._chol.nnz
        return (f"CSR quasi-def: n={self.nwcon} nnz(Cw)={nnz_a} "
                f"nnz(L)={nnz_l} fill={nnz_l / max(nnz_a, 1):.2f} "
                f"supernodes={self._chol.nsupernodes} "
                f"dense_cols={self.dense_cols.size}")
