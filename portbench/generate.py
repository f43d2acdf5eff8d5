"""The traffic generator: what a traffic file's parameters turn into.

Every draw comes from ``--seed`` and an index, so one seed gives the same
inputs in every run, and each draw is made on the card by a
`torch.Generator` of its own, in one call.
"""

from __future__ import annotations

import numpy as np
import torch


def key(seed: int) -> int:
    """The run's seed as the non-negative integer numpy's generators take
    (any whole number maps to one)."""
    return seed % 2 ** 64


def _stream(seed: int, index: int) -> int:
    """A 63-bit generator seed from the run's seed and a draw's index."""
    return int(np.random.SeedSequence([key(seed), index]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def start(nominal: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
          spec: dict, seed: int, index: int) -> torch.Tensor:
    """Start number ``index``: the model's nominal start scaled elementwise
    by U(spec['scale_low'], spec['scale_high']), clipped to the bounds."""
    gen = torch.Generator(device=nominal.device)
    gen.manual_seed(_stream(seed, index))
    u = torch.rand(nominal.shape, generator=gen, dtype=nominal.dtype,
                   device=nominal.device)
    lo, hi = spec["scale_low"], spec["scale_high"]
    return torch.minimum(torch.maximum(nominal * (lo + (hi - lo) * u), lb),
                         ub)


def sample(seed: int, among: int, size: int) -> set:
    """``size`` distinct indices below ``among``, drawn from the seed: the
    answers the check compares besides the window's last."""
    rng = np.random.default_rng([key(seed), among])
    return {int(i) for i in rng.choice(among, size=min(size, among),
                                       replace=False)}


# the index of the warm-up's start, which no window draw uses
WARMUP = 2 ** 31 - 1
