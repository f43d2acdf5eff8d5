"""What the portbench tests share: the cells' files cut to sizes the CPU
holds, and a run of the harness on them (the look for a card skipped)."""

from __future__ import annotations

import argparse

from portbench import harness

IP = "synth_ip_16m.starts1"
MMA = "cantilever3d_8m_mma.default_tol"


def small_config(cell: str, **solver) -> dict:
    """The cell's configuration at a size the CPU holds: 2^14 variables, or
    a 16 x 8 x 8 voxel grid."""
    manifest = harness.load_manifest()
    name = harness.cell_of(manifest, cell)["config"]
    conf = harness.load_json(harness.ROOT / next(
        c["file"] for c in manifest["configs"] if c["name"] == name))
    if "n" in conf["problem"]:
        conf["problem"]["n"] = 1 << 14
    else:
        conf["problem"].update(nex=16, ney=8, nez=8)
    conf["solver"].update(solver)
    return conf


def run_small(cell: str, seed: int = 5, seconds: float = 1.0, trace=0,
              config=None):
    """(result, stderr lines) of the harness's run of ``cell`` on the CPU at
    the small size, with the cell's own limits."""
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return harness.execute(args, harness.load_manifest(),
                           harness.Device("cpu"),
                           config=config or small_config(cell))
