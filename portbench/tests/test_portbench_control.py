"""The controls of `correct` come out not correct.

On the CPU: the synthetic problem's control, the reference computed in
TF32 (emulated: `reference._plain.round_tf32`) in the program's place, at
the small size.  On the card (marked ``cuda``, skipped without one): each
cell's control at the cell's own size, one seed, a short window at the
cell's load: the reference in TF32 for the synthetic problem, the program
with its own float32 products in TF32 for the cantilever (PERF.md gives
the readings on more seeds).  ``python3 -m pytest portbench/tests -m
cuda`` runs these on the card."""

import pytest

from portbench import control, harness
from portbench.tests._small import IP, MMA, small_config


def _limits(cell):
    return harness.load_json(harness.BENCH / "limits" / f"{cell}.json")


def _cell(name):
    return harness.cell_of(harness.load_manifest(), name)


def _failed(reading, limits):
    return [k for k, v in reading.items() if v > limits[k]]


def test_ip_reference_control_on_the_cpu():
    out = control.readings(_cell(IP), small_config(IP), 7, 0.3,
                           harness.Device("cpu"),
                           ("program", "reference_tf32"))
    limits = _limits(IP)
    assert not _failed(out["program"], limits)
    assert _failed(out["reference_tf32"], limits) == ["eval_gap"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "own size")
    return harness.Device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell, which, seconds", [
    (IP, "reference_tf32", 10.0), (MMA, "program_tf32", 22.0)])
def test_control_at_the_cells_size(card, cell, which, seconds):
    manifest = harness.load_manifest()
    conf = next(c for c in manifest["configs"]
                if c["name"] == _cell(cell)["config"])
    config = harness.load_json(harness.ROOT / conf["file"])
    out = control.readings(_cell(cell), config, 11, seconds, card,
                           ("program", which))
    limits = _limits(cell)
    assert not _failed(out["program"], limits)
    assert _failed(out[which], limits)
