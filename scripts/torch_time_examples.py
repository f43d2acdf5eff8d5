"""Seconds of the port's example programs on the card, each run in this
process under a time limit, one JSON line per run after a line with the
card's name and power limit; each program's output goes to
``OUT/ex_<i>_<name>.txt``.

    python3 scripts/torch_time_examples.py [--limit 150] [--out DIR] \\
        [name[:flag,value,...] ...]

With no names it times the runs that sized chip_smoke.EXAMPLE_CUTS: the
programs with an iteration flag at a few outer iterations, the others at
their defaults (cart_pole capped at 10 iterations through its
main's ``max_iters``).  ``--cuts`` runs chip_smoke.EXAMPLES as its phase
38(c) does (EXAMPLE_CUTS), and ``--device cpu`` runs them on the CPU in
float64: the references of chip_smoke.EXAMPLE_HOLDS come from

    python3 scripts/torch_time_examples.py --cuts --device cpu"""

import argparse
import contextlib
import importlib
import io
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DEFAULT_RUNS = [
    ("fem_frequency", ["--iters", "5"]), ("fem_topology", ["--iters", "5"]),
    ("fem_topology3d", ["--iters", "5"]),
    ("fem_topology_tr", ["--iters", "5", "--starts", "0"]),
    ("fem_topology_tr", ["--iters", "5"]), ("maratos", []),
    ("openmdao_paraboloid", []), ("reduced_problem", []), ("rosenbrock", []),
    ("sellar", []), ("sparse_rosenbrock", []), ("ssto", []), ("topology", []),
    ("cart_pole", [], {"max_iters": 10}),
    ("small_problems", ["--starts", "1"]), ("small_problems", [])]


class _Timeout(Exception):
    pass


def _alarm(*_):
    raise _Timeout()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="*",
                    help="name or name:flag,value,... (default: the "
                         "sizing runs)")
    ap.add_argument("--limit", type=int, default=150,
                    help="seconds before a run is stopped")
    ap.add_argument("--out", default="build/example_times")
    ap.add_argument("--cuts", action="store_true",
                    help="chip_smoke.py phase 38(c)'s runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    runs = [(r.split(":")[0], r.split(":")[1].split(",") if ":" in r else [])
            for r in args.runs] or DEFAULT_RUNS
    if args.cuts:
        import chip_smoke
        runs = [(name, *chip_smoke.EXAMPLE_CUTS.get(name, ([], {})))
                for name in chip_smoke.EXAMPLES]
    cuda = args.device == "cuda"
    extra = [] if cuda else ["--device", "cpu"]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if cuda:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    signal.signal(signal.SIGALRM, _alarm)
    for i, (name, flags, *kw) in enumerate(runs):
        mod = importlib.import_module(f"paropt_torch.examples.{name}")
        buf = io.StringIO()
        sync()
        t0 = time.perf_counter()
        signal.alarm(args.limit)
        out, status = None, "ok"
        try:
            with contextlib.redirect_stdout(buf):
                out = mod.main(list(flags) + extra, **(kw[0] if kw else {}))
        except _Timeout:
            status = "timeout"
        except SystemExit as e:
            status = f"exit {e.code}"
        finally:
            signal.alarm(0)
        sync()
        wall = time.perf_counter() - t0
        (out_dir / f"ex_{i}_{name}.txt").write_text(buf.getvalue())
        print(json.dumps({"name": name, "argv": flags,
                          "kwargs": kw[0] if kw else {}, "status": status,
                          "s": round(wall, 2), "out": out}, default=str),
              flush=True)


if __name__ == "__main__":
    main()
