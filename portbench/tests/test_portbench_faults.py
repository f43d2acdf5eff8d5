"""The comparison that decides `correct` sees each fault a cell can have,
planted underneath a whole run at the small size on the CPU (the look for
a card skipped): a step that returns its state unchanged, an answer
altered where it is produced, and, for the synthetic problem, the
objective's mean taken over half of the design.  Each cell is one chip
and one design at a time: it has no batch to halve and no exchange
between chips to leave out.  The unbroken runs come out correct."""

import dataclasses

import pytest
import torch

from portbench.jobs import mma_outer
from portbench.tests._small import IP, MMA, run_small, small_config


def _alternating(x, size):
    sign = 1.0 - 2.0 * (torch.arange(x.numel(), device=x.device) % 2)
    return torch.clamp(x + size * sign.to(x.dtype), 0.0, 1.0)


@pytest.mark.parametrize("cell", [IP, MMA])
def test_unbroken_runs_are_correct(cell):
    result, _ = run_small(cell, seconds=0.5)
    assert result["correct"], result["compared"]


def test_ip_state_unchanged(monkeypatch):
    from paropt_torch import ip_fused
    monkeypatch.setattr(ip_fused, "_fused_step",
                        lambda model, opts, state, *a, **k: state)
    result, _ = run_small(IP, seconds=0.1,
                          config=small_config(IP, max_major_iters=10))
    assert result["failed"] == result["attempted"] > 0
    assert not result["correct"]


def test_ip_answer_altered(monkeypatch):
    from paropt_torch import ip_fused
    solve = ip_fused.FusedIP.solve

    def altered(self, *args, **kw):
        st = solve(self, *args, **kw)
        v = dataclasses.replace(st.vars, x=_alternating(st.vars.x, 0.01))
        return dataclasses.replace(st, vars=v)

    monkeypatch.setattr(ip_fused.FusedIP, "solve", altered)
    result, _ = run_small(IP, seconds=0.1)
    assert not result["correct"]
    c = result["compared"]
    assert c["eval_gap"]["value"] > c["eval_gap"]["limit"]
    assert c["kkt_res"]["value"] > c["kkt_res"]["limit"]


def test_ip_objective_over_half(monkeypatch):
    from paropt_torch.models.topology import SyntheticTopology

    def half(self, x):
        n = x.shape[0] // 2
        xf = self._filter(x)[:n]
        return torch.sum(self.w[:n] / (self.eps + xf)) / n

    monkeypatch.setattr(SyntheticTopology, "objective", half)
    result, _ = run_small(IP, seconds=0.1)
    assert not result["correct"]
    c = result["compared"]["eval_gap"]
    assert c["value"] > c["limit"]


def test_mma_step_keeps_the_design(monkeypatch):
    from paropt_torch import mma
    tail = mma._mma_tail

    def stuck(state, head, inner):
        new = tail(state, head, inner)
        return dataclasses.replace(new, x=state.x, x1=state.x1,
                                   x2=state.x2)

    monkeypatch.setattr(mma, "_mma_tail", stuck)
    result, _ = run_small(MMA, seconds=0.5)
    assert not result["correct"]
    c = result["compared"]["step_gap"]
    assert c["value"] == pytest.approx(1.0) and c["value"] > c["limit"]


def test_mma_step_returns_its_state(monkeypatch):
    """A step that returns its whole state unchanged never brings the next
    iterate: the watchdog ends the window and the answer counts failed."""
    from paropt_torch import mma
    monkeypatch.setattr(mma, "_fused_mma_step",
                        lambda *args, **kw: args[-1])
    monkeypatch.setattr(mma_outer, "GRACE", 1.0)
    result, _ = run_small(MMA, seconds=0.2)
    assert result["failed"] >= 1
    assert not result["correct"]


def test_mma_answer_altered(monkeypatch):
    from paropt_torch import mma
    tail = mma._mma_tail

    def altered(state, head, inner):
        new = tail(state, head, inner)
        return dataclasses.replace(new, x=_alternating(new.x, 0.25))

    monkeypatch.setattr(mma, "_mma_tail", altered)
    result, _ = run_small(MMA, seconds=0.5)
    assert not result["correct"]
    c = result["compared"]["step_gap"]
    assert c["value"] > c["limit"]
