"""Plain reference of the synthetic topology problem (`configs/synth_ip_16m.json`)
and of ParOpt's interior-point residual.

The problem, for n design variables in blocks of `block`:

    min  sum_i w_i / (0.01 + xf_i) / n,   xf = k * x with edge padding
    s.t. V - mean(x) >= 0
         cap - mean(x[b::nwcon]) >= 0 for every block b < nwcon = n / block
         0 <= x <= 1

with w = 0.5 + numpy's default_rng(seed).random(n) and k the normalized
Hann window of `filter_width` taps (numpy's hanning(width + 2) without its
two zero ends).  The filter runs as one matrix product over tiles of the
padded design (a banded Toeplitz block), so that a lower precision of the
product shows.

`kkt_residual` is the infinity norm of ParOpt's perturbed KKT conditions
for this problem (every constraint an inequality with elastic slacks s, t
on the dense row and sw, tw on the sparse rows, and the barrier mu), over
the rows that hold an evaluation or a product:

    g - A' z - Aw' zw - zl + zu,   x zl - mu,   (1 - x) zu - mu,
    c - s + t,   s zs - mu,   t zt - mu,
    cw - sw + tw,   sw zsw - mu,   tw ztw - mu.

The four rows left out (z - zs, gamma - z - zt and their sparse pair) are
sums of the program's own multipliers and slacks alone: in float64 they
read how float32 rounds a slack multiplier near the penalty gamma = 1000
(half an ulp there is 3e-5), not a fact about the design.

numpy and torch only; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from ._plain import Precision, full_precision_products

TILE = 256
EPS = 0.01


class SyntheticTopology:
    """The problem of the module docstring in one precision."""

    def __init__(self, n, block=8, filter_width=5, volume_fraction=0.4,
                 block_cap=0.6, seed=0, precision="float64", device="cpu"):
        full_precision_products()
        if n % TILE or n % block:
            raise ValueError(f"n must be a multiple of {TILE} and of block")
        self.p = Precision(precision)
        self.kw = dict(dtype=self.p.dtype, device=device)
        self.n, self.block, self.nwcon = n, block, n // block
        self.volume_fraction, self.block_cap = volume_fraction, block_cap
        self.w = torch.as_tensor(
            0.5 + np.random.default_rng(seed).random(n), **self.kw)
        taps = np.hanning(filter_width + 2)[1:-1]
        taps = taps / taps.sum()
        self.pad = filter_width // 2
        # T[i + j, i] = taps[j]: a tile of TILE outputs from TILE + 2 pad
        # inputs
        T = np.zeros((TILE + 2 * self.pad, TILE))
        for j, tap in enumerate(taps):
            T[np.arange(TILE) + j, np.arange(TILE)] = tap
        self.T = torch.as_tensor(T, **self.kw)

    def _windows(self, x):
        """[n / TILE, TILE + 2 pad]: each tile of the edge-padded design
        with its halo."""
        xp = torch.cat([x[:1].expand(self.pad), x, x[-1:].expand(self.pad)])
        return xp.unfold(0, TILE + 2 * self.pad, TILE)

    def filter(self, x):
        return self.p.mm(self._windows(x), self.T).reshape(-1)

    def filter_t(self, h):
        """The adjoint of `filter`: the tiles' halos added back, the pads
        onto the end variables."""
        pad, n = self.pad, self.n
        win = self.p.mm(h.reshape(-1, TILE), self.T.T)    # [n/TILE, TILE+2p]
        # window t covers padded positions t * TILE .. t * TILE + TILE + 2p
        xp = torch.zeros(n + TILE, **self.kw)
        xp[:n].view(-1, TILE).add_(win[:, :TILE])
        xp[TILE:].view(-1, TILE)[:, :2 * pad].add_(win[:, TILE:])
        out = xp[pad:n + pad].clone()
        out[0] += xp[:pad].sum()
        out[-1] += xp[n + pad:n + 2 * pad].sum()
        return out

    def evaluate(self, x):
        """(objective, gradient, dense constraint, sparse constraints)."""
        x = x.to(self.p.dtype)
        xf = self.filter(x)
        f = torch.sum(self.w / (EPS + xf)) / self.n
        g = self.filter_t(-self.w / (EPS + xf) ** 2) / self.n
        c = self.volume_fraction - torch.mean(x)
        cw = self.block_cap - torch.mean(x.reshape(self.block, self.nwcon),
                                         dim=0)
        return f, g, c, cw

    def kkt_residual(self, v, g, c, cw, mu):
        """The infinity norm of the residual of the module docstring, from
        the iterate v (a dict of x and the multipliers and slacks z, zl, zu,
        s, t, zs, zt, zw, sw, tw, zsw, ztw) and the evaluations at
        v['x']."""
        v = {k: t.to(self.p.dtype) for k, t in v.items()}
        x, z, zw = v["x"], v["z"], v["zw"]
        awz = (-zw / self.block).repeat(self.block)        # Aw' zw
        parts = [
            g + z / self.n - awz - v["zl"] + v["zu"],
            x * v["zl"] - mu, (1.0 - x) * v["zu"] - mu,
            c - v["s"] + v["t"], v["s"] * v["zs"] - mu, v["t"] * v["zt"] - mu,
            cw - v["sw"] + v["tw"], v["sw"] * v["zsw"] - mu,
            v["tw"] * v["ztw"] - mu]
        return max(float(torch.max(torch.abs(p))) for p in parts)
