"""Job ``ip_solves_sharded``: whole `FusedIP.solve` calls, one design at a
time, on state sharded over a 1-D ("d",) mesh of ranks, one card each: the
program's sharded main path.

The harness process is the coordinator.  It starts the configuration's
``layout.ranks`` rank processes (this module run with ``python -m``) as
torchrun starts its ranks, each with one OpenMP thread, and binds each to
its own share of the cores; each rank is bound to ``cuda:r`` (gloo and
the CPU where the harness runs on the CPU) and joined by
`sharding.init_distributed`; the coordinator stays out of their group.  Each rank builds the problem as `ip_solves.build` does,
places the data and the QN state by `sharding.shard_tree` (design-length
leaves in shards, the rest replicated), warms up and runs the window as
`ip_solves` does, every rank on the same solve: each start is
`generate.start`'s draw from the seed, its uniforms made whole on every
card and each rank keeping its entries.  Rank 0 alone is profiled and
decides, after each solve, whether the window ends and whether the check
keeps the solve; the other ranks take its word.  Rank 0's profiled solve
also yields the device seconds of the NCCL kernels launched inside the
program's ``paropt.collective`` spans (linked to their launches by
correlation id), of the other device work launched there, and of every
NCCL kernel of the solve.  Each rank times each solve on the host: its
wall seconds, its main thread's and its process's CPU seconds, the main
thread's involuntary context switches and the garbage collector's
full collections; the coordinator writes them on stderr, rank by rank.

Each rank copies its shards of a kept solve's design-length fields to the
host as the solve ends; rank 0 keeps the replicated fields whole, and
every rank a digest of their bits.  The ranks hand their reports to the
coordinator through files in a temporary directory under TMPDIR and exit;
the coordinator joins the shards in rank order, counts the replicated
fields whose bits differ between ranks (``ranks_apart``), and compares
with the reference (`ip_solves.check`) on its own card once every rank
has freed its card.

A rank that exits with an error, or that finds JAX or the JAX package
loaded, ends the run: the coordinator kills every other rank at once, and
ends the run when the ranks have not exited ``GRACE`` seconds after the
window's length.

Traffic keys: those of `ip_solves`.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import hashlib
import json
import os
import pickle
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .. import generate
from ..harness import (PROCESS_START, ROOT, Device, Forbidden, Run, clock,
                       forbidden_modules, phases)
from ..trace import (DEVICE_CATS, LAUNCH_CATS, Profiler, _merged,
                     reduce_events)
from . import ip_solves

# what each rank runs: ``python -m <RANK_COMMAND...> --spec F --rank r``
RANK_COMMAND = ("portbench.jobs.ip_solves_sharded",)
# seconds a run may take beyond --seconds before the coordinator ends it
GRACE = 1200.0
# the exit code of a rank that found a forbidden module loaded
FORBIDDEN_EXIT = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, size: int = 6000) -> str:
    try:
        return path.read_text(errors="replace")[-size:]
    except OSError:
        return ""


def _wait(procs, tmp: Path, deadline: float) -> None:
    """Wait for every rank; at the first that fails, or at the deadline,
    raise (the caller kills the rest)."""
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code == FORBIDDEN_EXIT:
                with open(tmp / f"rank{r}.forbidden") as f:
                    raise Forbidden(json.load(f))
            if code not in (None, 0):
                raise RuntimeError(
                    f"rank {r} of {len(procs)} exited with {code}:\n"
                    + _tail(tmp / f"rank{r}.err"))
        if all(code == 0 for code in codes):
            return
        if clock() > deadline:
            raise RuntimeError(f"the ranks did not end by the deadline; "
                               f"rank 0:\n{_tail(tmp / 'rank0.err')}")
        time.sleep(0.1)


def _core_shares(ranks: int) -> list:
    """Each rank's own cores: the cores this process may use, cut into
    ``ranks`` equal runs (None for each where there are fewer cores than
    ranks)."""
    cores = sorted(os.sched_getaffinity(0))
    per = len(cores) // ranks
    return [cores[r * per:(r + 1) * per] if per else None
            for r in range(ranks)]


def _host_lines(reports) -> str:
    """Each rank's host seconds per solve of the window, for stderr."""
    out = []
    for r, rep in enumerate(reports):
        cols = zip(*rep["host"])
        wall, thread, proc, switches, gcs = (list(c) for c in cols)
        out.append(
            f"portbench: rank {r} per solve: wall s "
            f"{[round(v, 3) for v in wall]}, main-thread cpu s "
            f"{[round(v, 3) for v in thread]}, process cpu s "
            f"{[round(v, 3) for v in proc]}, involuntary switches "
            f"{switches}, full collections {gcs}\n")
    return "".join(out)


def run(config, traffic, seed, seconds, trace, device) -> Run:
    import torch

    ranks = config["layout"]["ranks"]
    tmp = Path(tempfile.mkdtemp(prefix="portbench_sharded_"))
    spec = {"config": config, "traffic": traffic, "seed": seed,
            "seconds": seconds, "trace": bool(trace), "device": device.name,
            "ranks": ranks, "port": _free_port(), "out": str(tmp)}
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    shares = _core_shares(ranks)
    procs = []
    try:
        for r in range(ranks):
            with open(tmp / f"rank{r}.err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", *RANK_COMMAND, "--spec",
                     str(tmp / "spec.json"), "--rank", str(r)],
                    cwd=ROOT, env=env, stdin=subprocess.DEVNULL,
                    stdout=err, stderr=subprocess.STDOUT))
            if shares[r]:
                # before the rank starts a thread: its threads inherit
                os.sched_setaffinity(procs[-1].pid, shares[r])
        _wait(procs, tmp, clock() + seconds + GRACE)
        reports = []
        for r in range(ranks):
            with open(tmp / f"rank{r}.pkl", "rb") as f:
                reports.append(pickle.load(f))
        shards = [torch.load(tmp / f"rank{r}.pt", weights_only=True)
                  for r in range(ranks)]
        sys.stderr.write(_tail(tmp / "rank0.err", 20000))
        sys.stderr.write(_host_lines(reports))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return _joined(reports, shards, torch)


def _joined(reports, shards, torch) -> Run:
    """The run as rank 0 saw it, with the kept solves whole: design-length
    fields joined from the ranks' shards in rank order, the replicated
    ones from rank 0; ``ranks_apart`` counts the replicated fields of the
    kept solves whose digest on some rank differs from rank 0's."""
    head = reports[0]
    kept = {}
    for i, fields in shards[0].items():
        kept[i] = {k: (torch.cat([s[i][k] for s in shards])
                       if k in head["sharded"] else v)
                   for k, v in fields.items()}
    apart = sum(rep["digests"][i][k] != head["digests"][i][k]
                for rep in reports[1:] for i in head["digests"]
                for k in head["digests"][i])
    ends = dict(head["marks"], warmup=head["t0"])
    return Run(setup_s=head["t0"] - PROCESS_START, window_s=head["window_s"],
               peak_bytes=max(rep["peak_bytes"] for rep in reports),
               process_peak_bytes=max(rep["process_peak_bytes"]
                                      for rep in reports),
               attempted=head["attempted"], failed=head["failed"],
               units=head["units"], trace=head["trace"],
               answers={"kept": kept, "ranks_apart": apart},
               per_design_iters=head["iters"], setup_parts=phases(ends))


def check(run, config, traffic, reference, seed, device,
          control=False) -> dict:
    """`ip_solves.check` on the joined kept solves (``control`` as
    there), and ``ranks_apart``: the replicated fields whose bits differ
    between ranks (every rank runs the same program on the same
    replicated data, and each collective hands every rank the same sum,
    so any difference is a desync)."""
    out = ip_solves.check(run, config, traffic, reference, seed, device,
                          control)
    out["ranks_apart"] = run.answers["ranks_apart"]
    return out


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


def _local(t):
    from paropt_torch.parallel.sharding import is_sharded
    return t.to_local() if is_sharded(t) else t


def _is_shard(t) -> bool:
    from torch.distributed.tensor import Shard
    from paropt_torch.parallel.sharding import is_sharded
    return is_sharded(t) and any(isinstance(p, Shard) for p in t.placements)


def _keep(state) -> dict:
    """`ip_solves._kept` on this rank's local tensors: its shards of the
    design-length fields, and the replicated ones whole."""
    from paropt_torch.parallel.sharding import _tree_map
    return ip_solves._kept(_tree_map(_local, state))


def _sharded_fields(state) -> list:
    """The kept fields that are shards on this rank."""
    import torch
    from paropt_torch.parallel.sharding import _tree_map
    marks = _tree_map(lambda t: torch.tensor(_is_shard(t)), state)
    return sorted(k for k, v in ip_solves._kept(marks).items() if bool(v))


def _digest(t) -> str:
    """An exact digest of a tensor's bits."""
    import torch
    raw = t.reshape(-1).contiguous().view(torch.uint8).numpy()
    return hashlib.blake2b(raw.tobytes(), digest_size=16).hexdigest()


def _draw(nominal, lb, ub, spec, seed, index, n, lo):
    """This rank's part of `generate.start`'s start ``index``: the whole
    draw's uniforms made on the card with the same generator, cut to the
    rank's entries, and the same elementwise formula on the rank's
    entries of the nominal start and the bounds."""
    import torch
    gen = torch.Generator(device=nominal.device)
    gen.manual_seed(generate._stream(seed, index))
    u = torch.rand((n,), generator=gen, dtype=nominal.dtype,
                   device=nominal.device)[lo:lo + nominal.shape[0]]
    a, b = spec["scale_low"], spec["scale_high"]
    return torch.minimum(torch.maximum(nominal * (a + (b - a) * u), lb), ub)


def _collective_device(events) -> dict:
    """Device seconds, from a profiled solve's chrome-trace events, of
    the NCCL kernels launched inside the ``paropt.collective`` host
    ranges (``collective_device_s``), of the other device work launched
    there (``collective_other_device_s``: the collectives' own copies),
    and of every NCCL kernel in the trace (``nccl_device_s``).  A device
    op is linked to its launch by correlation id."""
    from paropt_torch.parallel.collectives import SPAN
    xs = [e for e in events if e.get("ph") == "X"]
    ranges = _merged((e["ts"], e["ts"] + e["dur"]) for e in xs
                     if e.get("cat") == "user_annotation"
                     and e.get("name") == SPAN)
    starts = [a for a, _ in ranges]
    inside = set()
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] < ranges[i][1]:
                inside.add(corr)
    out = dict.fromkeys(("collective_device_s", "collective_other_device_s",
                         "nccl_device_s"), 0.0)
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        nccl = e.get("name", "").startswith("nccl")
        secs = e["dur"] * 1e-6
        if nccl:
            out["nccl_device_s"] += secs
        if e.get("args", {}).get("correlation") in inside:
            out["collective_device_s" if nccl
                else "collective_other_device_s"] += secs
    return out


class _Profiler(Profiler):
    """`trace.Profiler` whose `Trace` also holds `_collective_device`'s
    seconds in its ``units``."""

    def stop(self):
        self.device.sync()
        window = self.clock() - self.t0
        self.prof.stop()
        self._restore()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        tr = reduce_events(events, window, self.calls)
        tr.units.update(_collective_device(events))
        return tr


def _host_now() -> tuple:
    """(wall, main-thread CPU, process CPU) seconds, the main thread's
    involuntary context switches and the full collections so far."""
    use = resource.getrusage(getattr(resource, "RUSAGE_THREAD",
                                     resource.RUSAGE_SELF))
    return (clock(), time.thread_time(), time.process_time(),
            use.ru_nivcsw, gc.get_stats()[-1]["collections"])


def _window(spec, rank, fused, data, qn, draw, device, dev) -> tuple:
    """The window of this rank, as `ip_solves.run` runs it: (its counts,
    its kept solves' fields, the kept fields that are shards)."""
    import torch
    import torch.distributed as dist

    from paropt_torch.parallel import collectives
    traffic = spec["traffic"]
    tol = spec["config"]["solver"]["abs_res_tol"]
    sample = generate.sample(spec["seed"], traffic["check"]["among"],
                             traffic["check"]["sample"])
    dist.barrier()
    t0 = clock()
    reads0 = fused.syncs.count
    collectives.reset()
    kept, iters, failed, stalled, tr, sharded = {}, [], 0, 0, None, None
    host = []
    i = 0
    while True:
        before = _host_now()
        x0 = draw(i)
        prof = None
        if rank == 0 and spec["trace"] and i == traffic["profile_solve"]:
            prof = _Profiler(clock, device)
            prof.start()
        st = fused.solve(x0, data, (), qn, None)
        k, conv, res = torch.stack([
            _local(st.k).double(), _local(st.converged).double(),
            _local(st.res_norm).double()]).tolist()
        if prof is not None:
            tr = prof.stop()
            tr.units["ip_steps"] = int(k)
        iters.append(int(k))
        failed += not conv
        stalled += bool(conv) and res >= tol
        if rank == 0 and (not conv or res >= tol):
            print(f"portbench: solve {i} ended at step {int(k)}, converged "
                  f"{bool(conv)}, residual {res!r} (tolerance {tol})",
                  file=sys.stderr, flush=True)
        window = clock() - t0
        last = window >= spec["seconds"] and (tr is not None
                                              or not spec["trace"])
        # rank 0's word on the window's end and on the kept solves
        word = torch.tensor([last, i in sample or last or res >= tol],
                            dtype=torch.int32, device=dev)
        dist.broadcast(word, src=0)
        last, keep = (bool(v) for v in word.tolist())
        host.append(tuple(b - a for a, b in zip(before, _host_now())))
        if keep:
            kept[i] = _keep(st)
            sharded = sharded or _sharded_fields(st)
        del st
        i += 1
        if last:
            break
    report = {"t0": t0, "window_s": window, "peak_bytes": device.peak_bytes(),
              "attempted": len(iters), "failed": failed, "iters": iters,
              "trace": tr, "host": host, "units": {
                  "designs": len(iters) - failed, "solves": len(iters),
                  "stalled": stalled, "ip_steps": sum(iters),
                  "host_reads": fused.syncs.count - reads0,
                  "collectives": collectives.COUNTS["calls"],
                  "collective_bytes": collectives.COUNTS["bytes"],
                  "collective_kinds": {k: list(v) for k, v in
                                       collectives.BY_KIND.items()}}}
    if tr is not None:
        report["units"].update(
            (k, v) for k, v in tr.units.items() if k.endswith("device_s"))
    return report, kept, sharded


def rank_main(spec: dict, rank: int) -> None:
    """One rank: join the group, set up, run the window, and write the
    report (``rank{r}.pkl``) and the kept fields (``rank{r}.pt``) into
    the run's directory."""
    marks = {"spawn": PROCESS_START}
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    # the counter of collectives this job reads (a tree without it fails
    # here, before any set-up)
    from paropt_torch.parallel import collectives, sharding  # noqa: F401
    marks["imports"] = clock()

    config, ranks = spec["config"], spec["ranks"]
    cuda = spec["device"] == "cuda"
    if not cuda:
        torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    sharding.init_distributed(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://127.0.0.1:{spec['port']}", rank=rank,
        world_size=ranks)
    try:
        dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
        device = Device(spec["device"])
        mesh = sharding.design_mesh(dev.type)
        marks["group"] = clock()
        parts = {}
        prob, fused, data, nominal, qn0 = ip_solves.build(
            config, spec["seed"], torch, dev, parts)
        marks["problem"] = parts["problem"]
        n = prob.nvars
        lo, hi = rank * n // ranks, (rank + 1) * n // ranks
        data_s = sharding.shard_tree(data, mesh, n)
        qn_s = sharding.shard_tree(qn0, mesh, n)
        bounds = tuple(t[lo:hi].clone() for t in (nominal, data.lb,
                                                   data.ub))
        del data, qn0, nominal
        marks["shard"] = clock()

        def draw(i):
            x = _draw(*bounds, spec["traffic"]["start"], spec["seed"], i, n,
                      lo)
            return DTensor.from_local(x, mesh, [Shard(0)], run_check=False,
                                      shape=(n,), stride=(1,))

        fused.solve(draw(generate.WARMUP), data_s, (), qn_s, None,
                    max_iters=spec["traffic"]["warmup_steps"])
        device.sync()
        setup_peak = device.peak_bytes()
        device.reset_peak()
        report, kept, sharded = _window(spec, rank, fused, data_s, qn_s,
                                        draw, device, dev)
        bad = forbidden_modules()
        if bad:
            with open(os.path.join(spec["out"], f"rank{rank}.forbidden"),
                      "w") as f:
                json.dump(bad, f)
            sys.exit(FORBIDDEN_EXIT)
        report.update(
            marks=marks, sharded=sharded,
            process_peak_bytes=max(setup_peak, report["peak_bytes"]),
            digests={i: {k: _digest(v) for k, v in fields.items()
                         if k not in sharded}
                     for i, fields in kept.items()})
        if rank:
            kept = {i: {k: v for k, v in fields.items() if k in sharded}
                    for i, fields in kept.items()}
        out = Path(spec["out"])
        torch.save(kept, out / f"rank{rank}.pt")
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(report, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one rank of the job")
    ap.add_argument("--spec", required=True)
    ap.add_argument("--rank", type=int, required=True)
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    rank_main(spec, args.rank)


if __name__ == "__main__":
    main()
