"""The reader of the gradients that reused their evaluation's state
(``paropt.fem.state_reuse`` spans) per outer iteration, on synthetic
chrome-trace events."""

from portbench.harness import Run, read_metric
from portbench.trace import reduce_events
from portbench.tests.test_portbench_span_metrics import _host, _kernel, _run


def _mma_outer(t0, reuse):
    """One outer iteration: the evaluation's solve, then the gradient (in
    a reuse span where it reused the state, else with a solve of its own),
    then the inner IP."""
    events = [_host("paropt.mma.outer", t0, 1000),
              _host("paropt.mma.eval", t0, 600),
              _host("paropt.fem.solve", t0 + 10, 280)]
    if reuse:
        events.append(_host("paropt.fem.state_reuse", t0 + 300, 50))
    else:
        events.append(_host("paropt.fem.solve", t0 + 300, 280))
    return events + [_host("paropt.mma.inner_ip", t0 + 600, 400),
                     _kernel(t0 + 20, 250), _kernel(t0 + 620, 300)]


def test_state_reuse_per_outer_iteration():
    events = _mma_outer(0, True) + _mma_outer(1000, True)
    tr = reduce_events(events, window_s=2000e-6)
    run = _run(tr, outer_iterations=2)
    assert read_metric("fem_state_reuse_per_it", run, {}) == 1.0
    # one gradient of two reused its evaluation's state
    tr = reduce_events(_mma_outer(0, True) + _mma_outer(1000, False),
                       window_s=2000e-6)
    run = _run(tr, outer_iterations=2)
    assert read_metric("fem_state_reuse_per_it", run, {}) == 0.5
    # the IP cell counts no outer iterations: nothing to read there
    assert read_metric("fem_state_reuse_per_it", _run(tr, ip_steps=2),
                       {}) is None


def test_state_reuse_absent_reads_nothing():
    """A program without the span (one whose every gradient solves again),
    or a run without a trace, reads as nothing, not as 0."""
    tr = reduce_events(_mma_outer(0, False) + _mma_outer(1000, False),
                       window_s=2000e-6)
    run = _run(tr, outer_iterations=2)
    assert read_metric("fem_state_reuse_per_it", run, {}) is None
    assert tr.range_count["paropt.fem.solve"] == 4
    run = Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0, units={"outer_iterations": 2})
    assert read_metric("fem_state_reuse_per_it", run, {}) is None
