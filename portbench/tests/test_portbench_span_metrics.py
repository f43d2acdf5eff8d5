"""The readers of the program's spans, on synthetic chrome-trace events:
idle time put down to the host's reads, the inner IP's steps per outer
iteration and the line search's trials per step."""

import pytest

from portbench.harness import Run, read_metric
from portbench.trace import reduce_events

READ = "paropt.host_read"


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1, "args": {}}


def _host(name, ts, dur):
    return _x(name, "user_annotation", ts, dur)


def _kernel(ts, dur):
    return _x("elementwise", "kernel", ts, dur)


def _run(tr, **units):
    tr.units = units
    return Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
               attempted=1, failed=0, trace=tr)


# two IP steps of one solve: the first backtracks once (two trials, two
# reads), the second takes its first trial; a `converged` read after each
STEPS = [
    _host("paropt.ip.solve", 0, 1000),
    _host("paropt.ip.step", 0, 400),
    _host("paropt.line_search_trial", 10, 40),
    _host(READ, 60, 40),
    _host("paropt.line_search_trial", 110, 40),
    _host(READ, 160, 40),
    _host("paropt.ip.tail", 210, 190),
    _host(READ, 400, 50),
    _host("paropt.ip.step", 450, 400),
    _host("paropt.line_search_trial", 460, 40),
    _host(READ, 510, 40),
    _host("paropt.ip.tail", 560, 290),
    _host(READ, 850, 50),
    # the device: it drains while the host waits in a read, and idles
    # until the host's next launch
    _kernel(0, 80), _kernel(100, 80), _kernel(220, 100), _kernel(420, 100),
    _kernel(560, 120), _kernel(870, 10), _kernel(910, 90),
]


def test_sync_idle_per_step():
    tr = reduce_events(STEPS, window_s=1000e-6)
    gaps = dict(tr.idle_gaps)
    # gaps that began inside a read: [80, 100), [180, 220), [520, 560) and
    # [880, 910): 130 us
    assert gaps[READ] == pytest.approx(130e-6)
    # those that began in a tail: [320, 420) and [680, 870)
    assert gaps["paropt.ip.tail"] == pytest.approx(290e-6)
    assert set(gaps) == {READ, "paropt.ip.tail"}
    run = _run(tr, ip_steps=2)
    assert read_metric("sync_idle_ms.solve", run, {}) == pytest.approx(0.065)
    assert read_metric("ls_trials_per_step", run, {}) == pytest.approx(1.5)
    # the IP cell counts no outer iterations: nothing to read there
    assert read_metric("inner_ip_steps", run, {}) is None


def test_inner_steps_per_outer_iteration():
    outer = [_host("paropt.mma.outer", 0, 1000),
             _host("paropt.mma.inner_ip", 100, 900)] + STEPS[1:]
    tr = reduce_events(outer, window_s=1000e-6)
    run = _run(tr, outer_iterations=1)
    assert read_metric("inner_ip_steps", run, {}) == 2.0
    # the MMA cell counts no IP solve's steps: no reads per step there
    assert read_metric("sync_idle_ms.solve", run, {}) is None


def test_gap_in_a_read_nested_in_a_step_is_the_read():
    """A read inside a step inside the solve: the gap that begins there is
    the read's, not the step's or the solve's."""
    events = [_host("paropt.ip.solve", 0, 500),
              _host("paropt.ip.step", 0, 500), _host(READ, 100, 50),
              _kernel(0, 120), _kernel(300, 50)]
    tr = reduce_events(events, window_s=500e-6)
    assert dict(tr.idle_gaps) == {READ: pytest.approx(180e-6)}
    run = _run(tr, ip_steps=1)
    assert read_metric("sync_idle_ms.solve", run, {}) == pytest.approx(0.18)


def test_sync_idle_left_out_when_reads_are_not_kept(capsys):
    """Only the ten largest names are kept: reads below them, or a program
    without the span, read as nothing, with a line on stderr, not as 0."""
    events = [_kernel(0, 10)]
    for i in range(11):
        t = 1000 * (i + 1)
        events += [_host(f"paropt.phase{i}", t - 990, 990), _kernel(t, 10)]
    events += [_host(READ, 11_010, 5), _kernel(11_020, 10)]
    tr = reduce_events(events, window_s=12e-3)
    assert len(tr.idle_gaps) == 10 and READ not in dict(tr.idle_gaps)
    run = _run(tr, ip_steps=1)
    assert read_metric("sync_idle_ms.solve", run, {}) is None
    err = capsys.readouterr().err
    assert "sync_idle_ms.solve left out" in err and READ in err


def test_nothing_traced_or_no_steps_reads_nothing():
    run = Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0, units={"ip_steps": 10})
    for name in ("sync_idle_ms.solve", "inner_ip_steps",
                 "ls_trials_per_step"):
        assert read_metric(name, run, {}) is None
    # a trace of a program without the step spans (the parent's)
    tr = reduce_events([_host("paropt.eval", 0, 10), _kernel(0, 5)],
                       window_s=20e-6)
    run = _run(tr, ip_steps=1, outer_iterations=1)
    assert read_metric("inner_ip_steps", run, {}) is None
    assert read_metric("ls_trials_per_step", run, {}) is None
