"""The controls of `correct`, on the card at a cell's own size:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 8]

For each seed, the cell's run at a short window (the cell's own load) and
its comparison with the plain reference, three times over: ``program``,
the program as the configuration states it (the lower readings of the
limits); ``program_tf32``, the program with its own float32 products in
TF32 (the control where that path changes a compared number);
``reference_tf32``, the reference computed in TF32 in the program's place
at the same iterates (`reference/_plain.py`).  One JSON line per seed.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402  (the checkout on the path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--controls", default="program,reference_tf32,"
                    "program_tf32", help="which readings to take")
    args = ap.parse_args(argv)
    manifest = harness.load_manifest()
    cell = harness.cell_of(manifest, args.workload)
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = harness.load_json(harness.ROOT / conf["file"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, config, seed, args.seconds,
                                  harness.Device(args.device),
                                  args.controls.split(","))), flush=True)
    return 0


def readings(cell, config, seed, seconds, device,
             which=("program", "reference_tf32", "program_tf32")) -> dict:
    """{'seed', and each reading of ``which``: {number: value}} for one
    seed."""
    import importlib
    traffic = harness.load_json(harness.BENCH / "traffic"
                                / f"{cell['traffic']}.json")
    job = importlib.import_module(f"portbench.jobs.{traffic['job']}")
    reference = importlib.import_module(
        f"portbench.reference.{cell['config']}")
    import torch
    out = {"seed": seed}
    if "program" in which or "reference_tf32" in which:
        run = job.run(config, traffic, seed, seconds, False, device)
        device.free()
        if "program" in which:
            out["program"] = job.check(run, config, traffic, reference, seed,
                                       device)
        if "reference_tf32" in which:
            out["reference_tf32"] = job.check(run, config, traffic,
                                              reference, seed, device,
                                              control=True)
        del run
        device.free()
    if "program_tf32" in which:
        run = job.run(config, traffic, seed, seconds, False, device,
                      tf32=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device.free()
        out["program_tf32"] = job.check(run, config, traffic, reference,
                                        seed, device)
    return out


if __name__ == "__main__":
    sys.exit(main())
