"""What the example programs share: the ``--device`` flag, the
accelerator's dtype rule, host copies and the optional plot."""

from __future__ import annotations

import numpy as np
import torch


def add_device(ap):
    ap.add_argument("--device", default="cuda",
                    help="where the solver's tensors live (default: the "
                         "CUDA card; 'cpu' to run without one)")


def accelerator_dtype(device) -> torch.dtype:
    """float32 on the card, float64 on the CPU (the JAX scripts' rule for
    an accelerator, e.g. examples/topology.py:36)."""
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64


def host(x) -> np.ndarray:
    """A tensor (or anything array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None (with a message) when
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no plot written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def chunk_arg(value):
    """The ``--chunk`` flag: an int, 'auto', or 'none' (one window)."""
    if value == "none":
        return None
    return value if value == "auto" else int(value)
