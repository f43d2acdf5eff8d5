"""The sharded cell, `synth_ip_128m_4card.sharded`, at the small size on
the CPU: the harness's whole run with its four ranks as gloo processes
(the look for cards skipped), a rank made to raise, a replicated field
made to differ between ranks, the start each rank draws, the new readers
and the control of ``correct``.  A run takes about half a minute: four
ranks on few cores exchange ~75 collectives per IP step."""

import os
import time

import pytest
import torch

from portbench import control, generate, harness
from portbench.harness import Run, read_metric
from portbench.jobs import ip_solves_sharded as job
from portbench.tests._small import run_small, small_config
from portbench.trace import reduce_events

CELL = "synth_ip_128m_4card.sharded"
SEED = 2 ** 40 + 7


def _children() -> list:
    """Command lines of this process's live child processes."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and ("ip_solves_sharded" in cmd
                                    or "_sharded_faults" in cmd):
            out.append(cmd)
    return out


@pytest.fixture(scope="module")
def traced():
    return run_small(CELL, seed=SEED, seconds=0.1, trace=1)


def test_traced_run_is_correct(traced):
    result, lines = traced
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["compared"]["ranks_apart"]["value"] == 0
    assert result["device"]["count"] == 4
    assert not _children()


def test_traced_run_reads_the_counters(traced):
    metrics = traced[0]["metrics"]
    for name in ("collectives_per_step", "collective_mib_per_step",
                 "iters_per_solve"):
        assert metrics[name]["value"] > 0, name
    # the CPU's trace holds no device time: the device readers are left
    # out (the reader on device events is held below)
    assert "collective_device_ms" not in metrics


def test_a_rank_that_raises_ends_the_run(monkeypatch):
    monkeypatch.setattr(job, "RANK_COMMAND",
                        ("portbench.tests._sharded_faults", "raise"))
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 2 of 4 exited"):
        run_small(CELL, seed=SEED, seconds=0.1)
    assert time.perf_counter() - t0 < 120
    assert not _children()


def test_a_rank_one_ulp_apart_is_not_correct(monkeypatch):
    monkeypatch.setattr(job, "RANK_COMMAND",
                        ("portbench.tests._sharded_faults", "ulp"))
    result, _ = run_small(CELL, seed=SEED, seconds=0.1)
    assert result["compared"]["ranks_apart"]["value"] >= 1
    assert not result["correct"]


def test_reference_control_is_not_correct():
    """The reference in TF32 in the program's place fails ``eval_gap``,
    as in the one-card cell; the program's own reading passes."""
    cell = harness.cell_of(harness.load_manifest(), CELL)
    limits = harness.load_json(harness.BENCH / "limits" / f"{CELL}.json")
    out = control.readings(cell, small_config(CELL), 7, 0.1,
                           harness.Device("cpu"),
                           ("program", "reference_tf32"))
    assert all(v <= limits[k] for k, v in out["program"].items())
    assert [k for k, v in out["reference_tf32"].items()
            if v > limits[k]] == ["eval_gap"]


@pytest.mark.parametrize("ranks", [1, 4])
def test_each_rank_draws_its_part_of_the_start(ranks):
    n = 1 << 12
    nominal = torch.full((n,), 0.3)
    lb, ub = torch.zeros(n), torch.ones(n)
    spec = {"scale_low": 0.5, "scale_high": 1.5}
    whole = generate.start(nominal, lb, ub, spec, SEED, 3)
    parts = []
    for r in range(ranks):
        lo, hi = r * n // ranks, (r + 1) * n // ranks
        parts.append(job._draw(nominal[lo:hi], lb[lo:hi], ub[lo:hi], spec,
                               SEED, 3, n, lo))
    assert torch.equal(torch.cat(parts), whole)


def test_collective_device_ms_reads_the_span():
    """Every NCCL kernel of the profiled solve counts; the part launched
    inside a ``paropt.collective`` range (wherever and whenever it runs
    on the device) and the range's own copies are told apart."""
    def x(name, cat, ts, dur, corr=None):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "tid": 1, "args": {} if corr is None
                else {"correlation": corr}}

    events = [x("paropt.collective", "user_annotation", 0, 30),
              x("nccl:all_gather", "user_annotation", 4, 10),
              x("cudaLaunchKernelExC", "cuda_runtime", 5, 2, 7),
              x("cudaLaunchKernel", "cuda_runtime", 20, 2, 8),
              x("cuLaunchKernelEx", "cuda_driver", 40, 2, 9),
              x("cudaLaunchKernel", "cuda_runtime", 50, 2, 10),
              x("ncclDevKernel_AllGather", "kernel", 100, 200, 7),
              x("direct_copy", "kernel", 300, 50, 8),
              x("ncclDevKernel_SendRecv", "kernel", 350, 100, 9),
              x("elementwise", "kernel", 450, 100, 10)]
    tr = reduce_events(events, window_s=600e-6)
    tr.units.update(job._collective_device(events), ip_steps=2)
    assert tr.units["collective_device_s"] == pytest.approx(200e-6)
    assert tr.units["collective_other_device_s"] == pytest.approx(50e-6)
    assert tr.units["nccl_device_s"] == pytest.approx(300e-6)
    run = Run(setup_s=0, window_s=0, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0, trace=tr)
    assert read_metric("collective_device_ms", run, {}) == \
        pytest.approx(0.15)
    del tr.units["nccl_device_s"]
    assert read_metric("collective_device_ms", run, {}) is None


def test_host_lines_name_each_rank_and_solve():
    reports = [{"host": [(1.0, 0.5, 0.75, 3, 0), (1.25, 0.5, 0.8, 4, 1)]},
               {"host": [(1.0, 0.25, 0.5, 0, 0), (1.5, 0.25, 0.5, 1, 0)]}]
    lines = job._host_lines(reports).splitlines()
    assert len(lines) == 2
    assert lines[1].startswith("portbench: rank 1 per solve: wall s "
                               "[1.0, 1.5], main-thread cpu s [0.25, 0.25]")
    assert lines[0].endswith("involuntary switches [3, 4], "
                             "full collections [0, 1]")


def test_each_rank_has_its_own_cores():
    shares = job._core_shares(4)
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        assert shares == [None] * 4
        return
    flat = [c for s in shares for c in s]
    assert len(set(flat)) == len(flat) == len(cores) // 4 * 4
    assert set(flat) <= set(cores)


def test_counter_readers_need_the_counter():
    run = Run(setup_s=0, window_s=1, peak_bytes=0, process_peak_bytes=0,
              attempted=1, failed=0,
              units={"ip_steps": 4, "collectives": 300,
                     "collective_bytes": 8 * 2 ** 20})
    assert read_metric("collectives_per_step", run, {}) == 75
    assert read_metric("collective_mib_per_step", run, {}) == 2
    run.units = {"ip_steps": 4}
    assert read_metric("collectives_per_step", run, {}) is None
    assert read_metric("collective_mib_per_step", run, {}) is None
