"""The port's span layer (`paropt_torch.utils.spans`) on small solves.

- With no profiler running, no span enters ``record_function`` (it is
  patched to raise), and the solves end on the same bits as under the
  profiler.
- Under ``torch.profiler`` (CPU), the exported chrome trace holds one
  ``paropt.ip.init`` and one ``paropt.ip.solve`` per solve loop, a
  ``paropt.ip.step`` per step inside it (k + 1 of them for a solve that
  converged: the last step freezes), a ``paropt.host_read`` per counted
  host read, the step's phases inside their step; for FusedMMA a
  ``paropt.mma.outer`` per outer iteration with its one state solve and,
  in its evaluation, the gradient's ``paropt.fem.state_reuse`` (no solve
  inside), and the multigrid spans nested level by level.
- On a card (``-m cuda``): a few FusedIP steps and one FusedMMA outer
  iteration make no device-to-host sync outside `ip.HostSyncs`, so every
  idle gap a read opens is named by its ``paropt.host_read`` span.

The file imports no jax, so it runs on the card's machine as
``python -m pytest tests/test_torch_spans.py -q -m cuda --noconftest``.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from paropt_torch import ip_fused as tip
from paropt_torch.ip import HostSyncs
from paropt_torch.mma import FusedMMA
from paropt_torch.models.fem_topology import FEMTopology
from paropt_torch.models.fem_topology3d import FEMTopology3D
from paropt_torch.models.topology import SyntheticTopology
from paropt_torch.ops import qn as tqn
from paropt_torch.tree import tmap
from paropt_torch.utils import spans

from ._torch_parity import cuda  # noqa: F401

torch.set_num_threads(1)

F64 = torch.float64
EPS = 1e-3          # µs: the export's rounding of a span's ends


# ---------------------------------------------------------------------------
# solves and their traces
# ---------------------------------------------------------------------------


def _ip(device="cpu", dtype=F64, n=512):
    """(FusedIP, data, x0, QN state) on the synthetic model."""
    prob = SyntheticTopology(n=n, block=8, dtype=dtype, device=device)
    fused = tip.FusedIP(tip.model_from_problem(prob), n, 1, prob.nwcon, 1,
                        tip.FusedIPOptions(use_quasi_newton_update=True,
                                           abs_res_tol=1e-4),
                        dtype=dtype)
    data, x0 = tip.data_template_from_problem(prob, dtype=dtype)
    return fused, data, x0, tqn.qn_init(4, n, dtype=dtype, device=device)


def _mma(device="cpu", dtype=F64, iters=2, cg_iters=4):
    """FusedMMA on a 16 x 8 x 8 cantilever with a three-level multigrid
    CG, and the list its write-output hook fills."""
    prob = FEMTopology3D(16, 8, 8, solver="mgcg", cg_iters=cg_iters,
                         dtype=dtype, device=device)
    seen = []
    prob.write_output = lambda k, x: seen.append(k)
    solver = FusedMMA(prob, {"mma_output_file": None,
                             "mma_max_iterations": iters,
                             "write_output_frequency": 1,
                             "dtype": "float64" if dtype == F64
                             else "float32"})
    return solver, seen


def _solve_ip():
    fused, data, x0, qn0 = _ip()
    reads = fused.syncs.count
    st = fused.solve(x0, data, (), qn0, None)
    return {"state": st, "reads": fused.syncs.count - reads,
            "steps": int(st.k) + 1}


def _solve_ip_batched():
    fused, data, x0, qn0 = _ip()
    x0s = torch.stack([x0, 1.2 * x0])
    reads = fused.syncs.count
    st = fused.solve_batched(x0s, data, (), qn0)
    # the loop steps until its last instance froze
    return {"state": st, "reads": fused.syncs.count - reads,
            "steps": int(st.k.max()) + 1}


def _solve_mma():
    solver, seen = _mma()
    reads = solver.syncs.count
    res, st = solver.solve(chunk=1)
    return {"state": st, "result": res, "seen": seen,
            "reads": solver.syncs.count - reads, "outer": res["niter"]}


SOLVES = {"ip": _solve_ip, "ip_batched": _solve_ip_batched,
          "mma": _solve_mma}


def _traced(fn, tmp_path):
    """(fn's result, its spans [(name, start, end)] in start order) under a
    CPU profiler, from the chrome-trace export."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation")
    return out, [(n, a, b) for a, b, n in found]


def _named(found, name):
    return [s for s in found if s[0] == name]


def _inside(inner, outer):
    return outer[1] - EPS <= inner[1] and inner[2] <= outer[2] + EPS


def _within(found, name, outer):
    return [s for s in _named(found, name) if _inside(s, outer)]


def _leaves(tree):
    out = []
    tmap(lambda a: out.append(a), tree)
    return out


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


# ---------------------------------------------------------------------------
# the layer itself
# ---------------------------------------------------------------------------


def test_span_is_null_without_profiler_and_a_range_under_it(tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert spans.span("paropt.a") is spans.span("paropt.b")

    @spans.spanned("paropt.decorated")
    def work(x):
        with spans.span("paropt.inner"):
            return x + 1

    assert work(1) == 2
    out, found = _traced(lambda: work(2), tmp_path)
    assert out == 3
    assert [s[0] for s in found] == ["paropt.decorated", "paropt.inner"]
    assert _inside(found[1], found[0])
    assert work.__name__ == "work"


@pytest.mark.parametrize("method", ["__call__", "value", "values", "array",
                                    "upload"])
def test_each_counted_read_is_one_host_read_span(method, tmp_path):
    """Every read `HostSyncs` counts opens one ``paropt.host_read`` span;
    `upload`, which waits for nothing, opens none."""
    syncs = HostSyncs()
    t = torch.tensor(1.5, dtype=F64)
    calls = {"__call__": lambda: syncs(t > 1.0),
             "value": lambda: syncs.value(t),
             "values": lambda: syncs.values(t, t),
             "array": lambda: syncs.array(t),
             "upload": lambda: syncs.upload(np.ones(3), "cpu")}
    _, found = _traced(calls[method], tmp_path)
    assert len(_named(found, spans.HOST_READ)) == syncs.count
    assert syncs.count == (method != "upload")


@pytest.mark.parametrize("solve", list(SOLVES))
def test_no_profiler_no_record_function_and_same_bits(solve, tmp_path,
                                                      monkeypatch):
    """Without a profiler the solve makes no ``record_function`` call; its
    final state is the traced solve's, bit for bit."""
    traced, found = _traced(SOLVES[solve], tmp_path)
    assert found

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    plain = SOLVES[solve]()
    _assert_bit_equal(plain["state"], traced["state"])
    assert plain["reads"] == traced["reads"]
    if solve == "mma":
        a, b = plain["result"], traced["result"]
        assert torch.equal(a.pop("x"), b.pop("x")) and a == b


# ---------------------------------------------------------------------------
# the spans of a solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solve", ["ip", "ip_batched"])
def test_ip_solve_spans(solve, tmp_path):
    out, found = _traced(SOLVES[solve], tmp_path)
    (whole,) = _named(found, "paropt.ip.solve")
    steps = _named(found, "paropt.ip.step")
    assert len(steps) == out["steps"] > 5
    assert all(_inside(s, whole) for s in steps)
    # every counted read is a span, the converged reads inside the solve
    reads = _named(found, spans.HOST_READ)
    assert len(reads) == out["reads"]
    assert len(_within(found, spans.HOST_READ, whole)) == out["reads"]
    for step in steps:
        for phase in ("paropt.ip.head", "paropt.ip.merit", "paropt.ip.tail"):
            assert len(_within(found, phase, step)) == 1, phase
        (head,) = _within(found, "paropt.ip.head", step)
        (tail,) = _within(found, "paropt.ip.tail", step)
        assert len(_within(found, "paropt.kkt_factor", head)) == 1
        assert len(_within(found, "paropt.eval", tail)) == 1
        assert len(_within(found, "paropt.qn_update", tail)) == 1
        # one line-search trial per `done` read inside the step
        trials = _within(found, "paropt.line_search_trial", step)
        assert 1 <= len(trials) == len(_within(found, spans.HOST_READ, step))
    # the initial state before the loop, every other span inside it
    (init,) = _named(found, "paropt.ip.init")
    assert init[2] <= whole[1] + EPS
    assert all(_inside(s, whole) or _inside(s, init) for s in found)


def test_mma_solve_spans(tmp_path):
    out, found = _traced(_solve_mma, tmp_path)
    outers = _named(found, "paropt.mma.outer")
    assert len(outers) == out["outer"] == 2
    assert out["seen"] == [1, 2]
    assert len(_named(found, spans.HOST_READ)) == out["reads"]
    for outer in outers:
        assert len(_within(found, "paropt.fem.solve", outer)) == 1
        (evaluation,) = _within(found, "paropt.mma.eval", outer)
        (reuse,) = _within(found, "paropt.fem.state_reuse", evaluation)
        assert not _within(found, "paropt.fem.solve", reuse)
        (inner,) = _within(found, "paropt.mma.inner_ip", outer)
        assert len(_within(found, "paropt.ip.init", inner)) == 1
        (whole,) = _within(found, "paropt.ip.solve", inner)
        assert len(_within(found, "paropt.ip.step", whole)) >= 2
    # outside the outer iterations: the model's scale at construction and
    # the evaluation after the loop
    assert len(_named(found, "paropt.fem.solve")) == 2 * 1 + 2
    assert len(_named(found, "paropt.fem.state_reuse")) == 2


@pytest.mark.parametrize("dims", [(16, 8, 8), (32, 16)],
                         ids=["3d", "2d"])
def test_fem_solve_spans_by_level(dims, tmp_path):
    """One state solve: its multigrid set-up, the CG's fine-grid products,
    and each V-cycle's levels nested in order, the coarse solve innermost."""
    cg_iters = 3
    model = (FEMTopology3D if len(dims) == 3 else FEMTopology)(
        *dims, solver="mgcg", cg_iters=cg_iters, dtype=F64, device="cpu")
    levels = len(model._mg_dims)
    assert levels >= 3
    E = torch.full((model.nvars,), 0.7, dtype=F64)
    _, found = _traced(lambda: model._solve(E), tmp_path)
    (whole,) = _named(found, "paropt.fem.solve")
    assert len(_within(found, "paropt.fem.mg_setup", whole)) == 1
    assert len(_within(found, "paropt.fem.kmul", whole)) == cg_iters
    cycles = _named(found, "paropt.fem.mg.l0")
    assert len(cycles) == cg_iters + 1
    for cycle in cycles:
        outer = cycle
        for name in [f"paropt.fem.mg.l{l}" for l in range(1, levels - 1)] \
                + ["paropt.fem.mg.coarse"]:
            (outer,) = _within(found, name, outer)
    assert len(_named(found, "paropt.fem.mg.coarse")) == cg_iters + 1
    assert f"paropt.fem.mg.l{levels - 1}" not in {s[0] for s in found}


# ---------------------------------------------------------------------------
# on a card: every device-to-host sync is a counted read
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_no_sync_outside_host_reads(cuda, monkeypatch):  # noqa: F811
    """A few FusedIP steps and one FusedMMA outer iteration under
    ``set_sync_debug_mode("error")``, with `HostSyncs`'s reads let
    through: any other device-to-host sync raises."""

    def let_through(fn):
        def read(self, *args):
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(self, *args)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return read

    for name in ("__call__", "value", "values", "array"):
        monkeypatch.setattr(HostSyncs, name,
                            let_through(getattr(HostSyncs, name)))
    fused, data, x0, qn0 = _ip(cuda, torch.float32, n=1 << 14)
    solver, seen = _mma(cuda, torch.float32, iters=1, cg_iters=10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = fused.solve(x0, data, (), qn0, None, max_iters=3)
        res, _ = solver.solve(chunk=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(st.k) == 3 and fused.syncs.count >= 6
    assert res["niter"] == 1 and seen == [1] and solver.syncs.count > 3
