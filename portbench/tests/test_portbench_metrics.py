"""The metric arithmetic on synthetic runs and event lists: whole-window
rates, the in-flight solve rule, the trace's busy and idle time, its
range split, the custom-op calls and their roofline."""

import pytest

from portbench import roofline
from portbench.harness import BENCH, Device, Run, load_json, read_metric, \
    reported
from portbench.tests._small import IP, MMA, small_config
from portbench.trace import reduce_events


def run_of(**units):
    return Run(setup_s=12.5, window_s=50.0, peak_bytes=3 * 2 ** 30,
               process_peak_bytes=4 * 2 ** 30, attempted=1, failed=0,
               units=units)


def test_whole_window_rates():
    run = run_of(designs=40, ip_steps=920, host_reads=1960)
    assert read_metric("solve_s", run, {}) == 50.0 / 40
    assert read_metric("host_reads_per_it.solve", run, {}) == 1960 / 920
    assert read_metric("setup_s", run, {}) == 12.5
    assert read_metric("peak_mem_gib", run, {}) == 3.0
    # a unit the job did not count: nothing to read
    assert read_metric("outer_it_s", run, {}) is None
    assert read_metric("host_reads_per_it.outer", run, {}) is None
    mma = run_of(outer_iterations=20, host_reads=400)
    assert read_metric("outer_it_s", mma, {}) == 2.5
    assert read_metric("host_reads_per_it.outer", mma, {}) == 20.0
    assert read_metric("solve_s", mma, {}) is None


def test_no_design_no_rate():
    assert read_metric("solve_s", run_of(designs=0), {}) is None


def test_in_flight_solve_counts():
    """The window ends with the solve in flight at --seconds, and every
    solve of the window counts."""
    from portbench.jobs import ip_solves
    traffic = load_json(BENCH / "traffic" / "starts1.json")
    run = ip_solves.run(small_config(IP), traffic, 5, 0.5, False,
                        Device("cpu"))
    assert run.window_s >= 0.5
    assert run.attempted == run.units["solves"] == len(run.per_design_iters)
    assert read_metric("solve_s", run, traffic) == \
        run.window_s / run.units["designs"]
    assert read_metric("iters_per_solve", run, traffic) == \
        sum(run.per_design_iters) / run.attempted
    # the check's answers: the sampled solves and the last, on the host
    kept = run.answers["kept"]
    assert run.attempted - 1 in kept
    assert all(v.device.type == "cpu" for a in kept.values()
               for v in a.values())
    assert set(run.setup_parts) == {"imports", "problem", "solver",
                                    "warmup"}


def test_outer_iterations_window():
    """The window ends at the first boundary after --seconds."""
    from portbench.jobs import mma_outer
    traffic = load_json(BENCH / "traffic" / "default_tol.json")
    run = mma_outer.run(small_config(MMA), traffic, 5, 0.5, False,
                        Device("cpu"))
    assert run.window_s >= 0.5
    assert read_metric("outer_it_s", run, traffic) == \
        run.window_s / run.units["outer_iterations"]


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


EVENTS = [
    # host ranges and their device-side spans
    _x("paropt.kkt_factor", "user_annotation", 0, 100),
    _x("paropt.kkt_factor", "gpu_user_annotation", 10, 60),
    _x("paropt.eval", "user_annotation", 200, 300),
    # a custom op, its launches and their kernels
    _x("paropt::quasi_def_apply", "cpu_op", 20, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 25, 2, correlation=7),
    _x("cudaLaunchKernel", "cuda_runtime", 40, 2, correlation=8),
    _x("quasi_def_kernel", "kernel", 30, 20, correlation=7),
    _x("reduce_partials_kernel", "kernel", 50, 10, correlation=8),
    _x("elementwise", "kernel", 60, 10, correlation=9),
    _x("elementwise", "kernel", 250, 50, correlation=10),
    _x("Memcpy DtoH", "gpu_memcpy", 290, 20, correlation=11),
]


def test_busy_idle_and_ranges():
    tr = reduce_events(EVENTS, window_s=400e-6)
    # device busy: [30, 70) and [250, 310): 100 us of a 400 us window
    assert tr.busy_s == pytest.approx(100e-6)
    run = Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0, trace=tr)
    assert read_metric("device_idle.solve", run, {}) == pytest.approx(75.0)
    # the kkt_factor range's device span [10, 70) holds 40 us of ops
    assert tr.range_device_s["paropt.kkt_factor"] == pytest.approx(40e-6)
    assert tr.range_host_s["paropt.eval"] == pytest.approx(300e-6)
    assert tr.range_count["paropt.eval"] == 1
    # the gap [70, 250) began inside the kkt_factor range
    assert dict(tr.idle_gaps) == {"paropt.kkt_factor": pytest.approx(180e-6)}
    assert tr.device_ops[0] == ("elementwise", pytest.approx(60e-6))


def test_idle_gap_named_by_open_range():
    events = [_x("paropt.fem.solve", "user_annotation", 0, 1000),
              _x("k", "kernel", 0, 100), _x("k", "kernel", 400, 100)]
    tr = reduce_events(events, window_s=1e-3)
    assert dict(tr.idle_gaps) == {"paropt.fem.solve": pytest.approx(300e-6)}


def test_op_calls_and_roofline():
    dims = [[8, 1024], [1024], [8, 1024], [1, 8, 1024], [1, 1024]]
    calls = [("paropt::quasi_def_apply", dims, 4)]
    tr = reduce_events(EVENTS, window_s=400e-6, calls=calls)
    # the op's two launches started the two kernels: 30 us
    assert tr.op_calls == [("paropt::quasi_def_apply", dims, 4,
                            pytest.approx(30e-6))]
    tr.units = {"ip_steps": 2}
    run = Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0, trace=tr)
    want = 100 * roofline.call_bound_s("paropt::quasi_def_apply", dims,
                                       4) / 30e-6
    assert read_metric("kernel_roofline", run, {}) == pytest.approx(want)
    assert read_metric("ip_step_device_ms", run, {}) == pytest.approx(0.05)
    assert read_metric("kkt_factor_device_ms", run, {}) == \
        pytest.approx(0.02)


def test_unmatched_calls_are_left_out():
    # a logged call count that differs from the trace's: no call is kept
    tr = reduce_events(EVENTS, window_s=400e-6, calls=[])
    assert tr.op_calls == []
    assert tr.unmatched == [("paropt::quasi_def_apply", 0, 1)]
    run = Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0, trace=tr)
    assert read_metric("kernel_roofline", run, {}) is None


def test_one_unmatched_op_drops_the_roofline():
    """One op's calls matched and another's not: no share over a part of
    the kernels."""
    dims = [[8, 1024], [1024], [8, 1024], [1, 8, 1024], [1, 1024]]
    calls = [("paropt::quasi_def_apply", dims, 4),
             ("paropt::qn_roll_update", [[20, 1024]], 4)]
    tr = reduce_events(EVENTS, window_s=400e-6, calls=calls)
    assert [c[0] for c in tr.op_calls] == ["paropt::quasi_def_apply"]
    assert tr.unmatched == [("paropt::qn_roll_update", 1, 0)]
    run = Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0, trace=tr)
    assert read_metric("kernel_roofline", run, {}) is None


def test_nothing_traced_reads_nothing():
    run = run_of(ip_steps=10)
    for name in ("ip_step_device_ms", "kkt_factor_device_ms",
                 "kernel_roofline", "device_idle.solve", "mma_inner_ip_ms",
                 "fem_solve_device_ms", "fem_solve_host_ms"):
        assert read_metric(name, run, {}) is None


def test_reported_by_workloads_key():
    metrics = [{"name": "a", "workloads": ["x"]}, {"name": "b"}]
    assert [m["name"] for m in reported(metrics, "x")] == ["a", "b"]
    assert [m["name"] for m in reported(metrics, "y")] == ["b"]
