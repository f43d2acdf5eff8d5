"""The program's counter of collectives (`paropt_torch.parallel.collectives`)
and its span ``paropt.collective``.

A one-rank group issues no collective (DTensor moves nothing over a mesh
axis of size 1), so the counts come from two gloo ranks of
`paropt_torch.parallel.worker` (its ``count`` case: a FusedIP solve of one
step on SyntheticTopology(512) in f64).  The one-rank gloo group in the
pytest process checks where the wrappers are installed: during a solve
on sharded state, never during a plain one.
"""

import json
import os

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from paropt_torch import ip_fused
from paropt_torch.models.topology import SyntheticTopology
from paropt_torch.ops import qn as qnmod
from paropt_torch.parallel import collectives
from paropt_torch.parallel import sharding as sh
from paropt_torch.parallel.worker import spawn

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
N = 512


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' ``count`` results."""
    out = tmp_path_factory.mktemp("count")
    spawn(2, ["--cases", "count", "--device", "cpu", "--out", out,
              "--n", N, "--steps", 1, "--refine", 0], timeout=300, cwd=REPO)
    return [json.load(open(out / f"rank{r}.json"))["count"]
            for r in range(2)]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    path = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    try:
        yield sh.design_mesh("cpu")
    finally:
        dist.destroy_process_group()


class _Watched(SyntheticTopology):
    """Records, at each objective evaluation, whether the counter's
    wrappers are in place."""

    seen = []

    def objective(self, x):
        self.seen.append((collectives.installed(),
                          funcol.all_reduce is ORIGINAL))
        return super().objective(x)


ORIGINAL = funcol.all_reduce


def _solve(x0, data, qn0, prob):
    fused = ip_fused.FusedIP(
        ip_fused.model_from_problem(prob), N, 1, prob.nwcon, 1,
        ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                max_major_iters=1), dtype=F64)
    return fused.solve(x0, data, (), qn0, None)


def _problem():
    prob = _Watched(n=N, block=8, dtype=F64, device="cpu")
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=F64)
    return prob, data, x0, qnmod.qn_init(10, N, dtype=F64, device="cpu")


def test_counter_counts_a_two_rank_solve(ranks):
    for r in ranks:
        assert r["k"] == 1
        assert r["calls"] > 0 and r["bytes"] > 0
    # every rank issues the same collectives with the same local sizes
    assert ranks[0]["calls"] == ranks[1]["calls"]
    assert ranks[0]["bytes"] == ranks[1]["bytes"]


def test_collective_bytes_reads_the_counter(ranks):
    for r in ranks:
        assert r["reading"] == {"calls": r["calls"], "bytes": r["bytes"]}


def test_each_counted_call_is_a_span(ranks):
    for r in ranks:
        assert r["spans"] == r["calls"]


def test_results_bit_equal_with_counter_in_and_out(ranks):
    for r in ranks:
        assert r["uncounted"] == {"calls": 0, "bytes": 0}
        assert r["bit_equal"]
        assert not r["installed_after"]


def test_plain_solve_installs_nothing(mesh):
    prob, data, x0, qn0 = _problem()
    _Watched.seen = []
    collectives.reset()
    _solve(x0, data, qn0, prob)
    assert _Watched.seen and all(s == (False, True) for s in _Watched.seen)
    assert collectives.COUNTS == {"calls": 0, "bytes": 0}


def test_sharded_solve_installs_while_it_runs(mesh):
    prob, data, x0, qn0 = _problem()
    ds = sh.shard_tree(data, mesh, N)
    xs, qs = sh.shard_tree((x0, qn0), mesh, N)
    _Watched.seen = []
    _solve(xs, ds, qs, prob)
    assert _Watched.seen and all(s == (True, False) for s in _Watched.seen)
    assert not collectives.installed() and funcol.all_reduce is ORIGINAL


def test_counting_nests():
    with collectives.counting():
        with collectives.counting():
            assert collectives.installed()
        assert collectives.installed()
        assert funcol.all_reduce.__wrapped__ is ORIGINAL
    assert not collectives.installed() and funcol.all_reduce is ORIGINAL


def test_kinds_add_up_to_the_count(ranks):
    for r in ranks:
        kinds = r["kinds"]
        assert kinds and set(kinds) <= {
            name for _, names in collectives._TARGETS for name in names}
        assert sum(c for c, _ in kinds.values()) == r["calls"]
        assert sum(b for _, b in kinds.values()) == r["bytes"]
