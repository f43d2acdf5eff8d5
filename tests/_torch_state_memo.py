"""Checks of the compliance models' state memo
(`paropt_torch.models.fem_topology._StateMemo`), shared by the 2-D and 3-D
model tests: a gradient right after ``eval_obj_con`` at the same tensor
reuses that evaluation's state, runs no state solve and equals, bit for
bit, the gradient that solves again; any other call solves; no memo
outlives the gradient call or is held while a solve runs."""

import numpy as np
import torch

REUSE = "paropt.fem.state_reuse"


class Solves:
    """Counts a model's state solves, with the memo each found held (a DMO
    model solves through its ``fem``)."""

    def __init__(self, model):
        self.memos = []
        owner = getattr(model, "fem", model)
        solve = owner._solve

        def counted(E):
            self.memos.append(model._memo)
            return solve(E)

        owner._solve = counted

    @property
    def n(self):
        return len(self.memos)


def design(model, seed):
    x0, _, _ = model.get_vars_and_bounds()
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.1, 0.9, model.nvars),
                           dtype=x0.dtype)


def _gradient_spans(model, x):
    """(g, A) at x, and the names of the ranges the call opened."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        out = model.eval_obj_con_gradient(x)
    return out, [e.name for e in prof.events()]


def check_hit_equals_miss(model):
    """The gradient on a hit runs no solve, opens one reuse span and is
    ``torch.equal`` to the gradient on a clone of x, which solves."""
    x = design(model, 1)
    solves = Solves(model)
    f, _ = model.eval_obj_con(x)
    assert solves.n == 1
    (g, A), names = _gradient_spans(model, x)
    assert solves.n == 1
    assert names.count(REUSE) == 1
    (g_miss, A_miss), names = _gradient_spans(model, x.clone())
    assert solves.n == 2
    assert REUSE not in names
    assert g.dtype == x.dtype
    assert torch.equal(g, g_miss) and torch.equal(A, A_miss)
    assert torch.equal(f, model.objective(x.clone()))


def check_misses(model):
    """An in-place change of x, or an evaluation at another point, between
    the two calls: the gradient solves, and is the one at its x."""
    x = design(model, 2)
    solves = Solves(model)
    model.eval_obj_con(x)
    x.mul_(0.9)
    g, A = model.eval_obj_con_gradient(x)
    assert solves.n == 2
    g_want, A_want = model.eval_obj_con_gradient(x.clone())
    assert torch.equal(g, g_want) and torch.equal(A, A_want)
    model.eval_obj_con(x)
    model.eval_obj_con(design(model, 3))
    g, A = model.eval_obj_con_gradient(x)
    assert solves.n == 6
    assert torch.equal(g, g_want) and torch.equal(A, A_want)


def check_released(model):
    """No memo after a gradient call, hit or miss, and none held when a
    solve starts, whatever the evaluation before it kept."""
    x = design(model, 4)
    solves = Solves(model)
    model.eval_obj_con(x)
    assert model._memo is not None and model._memo[0] is x
    model.eval_obj_con_gradient(x)
    assert model._memo is None and model._kept is None
    model.eval_obj_con(x)
    model.eval_obj_con(x.clone())
    model.eval_obj_con_gradient(x)
    assert model._memo is None and model._kept is None
    assert solves.n == 4
    assert solves.memos == [None] * 4
