"""Synthetic large-scale topology-optimization-style problem (counterpart of
paropt_tpu/models/topology.py):

    min  Σ w_i / (eps + xf_i)          xf = smoothing filter applied to x
    s.t. V - mean(x) >= 0              (1 dense volume constraint)
         cap - blockmean(x) >= 0       (n/block sparse weighting constraints)
         0 <= x <= 1

The weights and filter taps come from ``numpy.random.default_rng(seed)``
exactly as in the JAX model, so both packages solve the same problem.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import resolve_device, resolve_dtype
from ..problem import Problem, SparseJacobian

__all__ = ["SyntheticTopology"]


class SyntheticTopology(Problem):
    def __init__(self, n: int = 1 << 20, block: int = 8,
                 filter_width: int = 5, volume_fraction: float = 0.4,
                 block_cap: float = 0.6, seed: int = 0,
                 use_sparse: bool = True, dtype=None, device=None):
        if n % block:
            raise ValueError("n must be a multiple of block")
        nwcon = n // block if use_sparse else 0
        super().__init__(nvars=n, ncon=1, nwcon=nwcon, nwblock=1)
        self.block = block
        self.volume_fraction = volume_fraction
        self.block_cap = block_cap
        self._dtype = resolve_dtype(dtype)
        self._device = resolve_device(device)
        rng = np.random.default_rng(seed)
        self.w = self._tensor(0.5 + rng.random(n))
        k = np.hanning(filter_width + 2)[1:-1]
        k = self._tensor(k)
        self.kernel = k / torch.sum(k)
        self.eps = 0.01
        if use_sparse:
            # transposed partition (variable i in block i mod nwcon): every
            # Jacobian product keeps the large axis minor (blocked_t)
            cols = (np.arange(nwcon, dtype=np.int32)[:, None]
                    + np.arange(block, dtype=np.int32)[None, :] * nwcon)
            vals = -np.full((nwcon, block), 1.0 / block)
            self._jac = SparseJacobian(nvars=n, cols=cols,
                                       vals=self._tensor(vals), nwblock=1)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self._dtype, device=self._device)

    def _filter(self, x):
        # shift-and-add stencil with edge padding (jnp.pad mode="edge")
        pad = self.kernel.shape[0] // 2
        n = x.shape[0]
        xp = torch.cat([x[:1].expand(pad), x, x[-1:].expand(pad)])
        out = torch.zeros_like(x)
        for j in range(self.kernel.shape[0]):
            out = out + self.kernel[j] * xp[j:j + n]
        return out

    def objective(self, x):
        xf = self._filter(x)
        return torch.sum(self.w / (self.eps + xf)) / x.shape[0]

    def constraints(self, x):
        return (self.volume_fraction - torch.mean(x)).reshape(1)

    def sparse_constraints(self, x):
        bm = torch.mean(x.reshape(self.block, self.nwcon), dim=0)
        return self.block_cap - bm

    def sparse_jacobian(self, x):
        return self._jac

    def get_vars_and_bounds(self):
        n = self.nvars
        kw = dict(dtype=self._dtype, device=self._device)
        return (torch.full((n,), 0.3, **kw), torch.zeros(n, **kw),
                torch.ones(n, **kw))
