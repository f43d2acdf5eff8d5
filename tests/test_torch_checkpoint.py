"""Checkpoints of the port (`paropt_torch.utils.checkpoint`, the host IP's
npz solution files, the fused solvers' ``checkpoint_path`` and
``ip_checkpoint_file``) against paropt_tpu's, on the CPU in float64:

- a host-IP npz file written mid-solve by either package resumes in both:
  the same iterations, fobj within 1e-10 relative (the QN approximation
  restarts on resume, as in the reference);
- a fused solve resumed from its own mid-solve checkpoint equals the
  uninterrupted run bit for bit (tests/test_chunked_output.py:61-91's
  case, and FusedTR, FusedEigenTR and the fused IP facade);
- a JAX Orbax checkpoint, restored by paropt_tpu and carried over by
  `paropt_torch.convert`, resumes in the port on JAX's uninterrupted
  trajectory (the same iterations, fobj within 1e-10, x within 1e-8);
- a template of another class, shape or static field raises; bfloat16 QN
  storage comes back as bfloat16."""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_torch import InteriorPoint as TIP
from paropt_torch import convert
from paropt_torch.ip_fused import fused_ip_optimize
from paropt_torch.models.topology import SyntheticTopology as TTop
from paropt_torch.mma import FusedMMA as TMMA
from paropt_torch.ops import qn as tqn
from paropt_torch.tr import FusedTR as TTR
from paropt_torch.utils.checkpoint import restore_state, save_state
from paropt_tpu import InteriorPoint as JIP
from paropt_tpu.models.topology import SyntheticTopology as JTop
from paropt_tpu.mma import FusedMMA as JMMA

from ._torch_parity import fields_of

torch.set_num_threads(1)
F64 = torch.float64


def _same(a, b) -> bool:
    """Two states equal leaf for leaf, bit for bit (None leaves alike)."""
    la, lb = (torch.utils._pytree.tree_leaves(s) for s in (a, b))
    return len(la) == len(lb) and all(
        (x is None and y is None) or torch.equal(x, y)
        for x, y in zip(la, lb))


def _top(pkg):
    return (JTop(n=64, block=8, dtype=jnp.float64) if pkg == "jax"
            else TTop(n=64, block=8, dtype=F64, device="cpu"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ip_solution_file_crosses_packages(writer, tmp_path):
    path = str(tmp_path / f"{writer}.npz")
    IP = {"jax": JIP, "torch": TIP}
    opts = {"output_file": None, "abs_res_tol": 1e-8}
    first = IP[writer](_top(writer), dict(opts, write_output_frequency=5,
                                          max_major_iters=12))
    first.optimize(checkpoint=path)
    res = {}
    for reader in ("jax", "torch"):
        ip = IP[reader](_top(reader), opts)
        ip.read_solution_file(path)
        assert ip.mu == float(np.load(path)["mu"])
        res[reader] = ip.optimize()
    assert res["torch"]["converged"] and res["jax"]["converged"]
    assert res["torch"]["niter"] == res["jax"]["niter"]
    np.testing.assert_allclose(res["torch"]["fobj"], res["jax"]["fobj"],
                               rtol=1e-10)


def test_ip_solution_file_checks_shapes(tmp_path):
    path = str(tmp_path / "small")
    ip = TIP(_top("torch"), {"output_file": None})
    ip.write_solution_file(path)                 # np.savez adds .npz
    other = TIP(TTop(n=128, block=8, dtype=F64, device="cpu"),
                {"output_file": None})
    with pytest.raises(ValueError, match="shape"):
        other.read_solution_file(path)
    # a directory is the checkpoint of sharded state (torch.distributed.
    # checkpoint, where paropt_tpu writes Orbax); its shapes are checked
    # the same way
    import torch.distributed as dist
    from paropt_torch.parallel.sharding import design_mesh, shard_tree
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        ip.vars = shard_tree(ip.vars, design_mesh("cpu"), 64)
        ip.write_solution_file(str(tmp_path / "sharded"))
        with pytest.raises(ValueError, match="shape"):
            other.read_solution_file(str(tmp_path / "sharded"))
    finally:
        dist.destroy_process_group()


MMA_OPTS = {"mma_output_file": None, "dtype": "float64",
            "write_output_frequency": 2, "mma_linfty_tol": 1e-12,
            "mma_l1_tol": 0.0}


def _mma(pkg, max_it):
    cls = JMMA if pkg == "jax" else TMMA
    return cls(_top(pkg), dict(MMA_OPTS, mma_max_iterations=max_it))


TR_OPTS = {"tr_output_file": None, "output_file": None, "dtype": "float64",
           "tr_init_size": 0.05, "tr_l1_tol": 0.0, "tr_linfty_tol": 1e-10,
           "abs_res_tol": 1e-10, "tr_write_output_frequency": 2}


def _tr(max_it):
    return TTR(_top("torch"), dict(TR_OPTS, tr_max_iterations=max_it))


def _eig(max_it):
    from .test_eig_fused_step import _opts
    from .test_torch_eig_fused import TTiny
    from paropt_torch.eig_fused import FusedEigenTR
    return FusedEigenTR(TTiny(n=8, N=2, seed=2), dict(_opts(
        {"tr_max_iterations": max_it, "tr_write_output_frequency": 2,
         "tr_l1_tol": 0.0, "tr_linfty_tol": 0.0})), index=1, qn_b0=1.0)


FUSED = {"mma": lambda it: _mma("torch", it), "tr": _tr, "eig": _eig}


@pytest.mark.parametrize("solver", sorted(FUSED))
def test_fused_resume_equals_uninterrupted(solver, tmp_path):
    """Solve A runs 10 outer iterations; solve B runs 4 and checkpoints at
    the cadence; C resumes B's checkpoint with a cap of 10 (the absolute
    count, JAX's rule) and lands on A bit for bit."""
    make = FUSED[solver]
    resA, stateA = make(10).solve()
    ckpt = str(tmp_path / "state.pt")
    solverB = make(4)
    _, stateB = solverB.solve(checkpoint_path=ckpt)
    restored = restore_state(ckpt, solverB._state0)
    k = int(restored.k)
    assert k == 4 and int(stateB.k) == 4
    _, stateC = make(10).solve(state0=restored)
    assert int(stateC.k) == int(stateA.k) == 10
    assert _same(stateA, stateC)


def test_fused_ip_facade_checkpoint_resumes(tmp_path):
    """``ip_checkpoint_file`` writes the full FusedState at the
    write_output cadence; a solve resumed from it (``state0``) ends on the
    uninterrupted solve bit for bit."""
    ckpt, mid = str(tmp_path / "ip.pt"), str(tmp_path / "mid.pt")
    opts = {"dtype": "float64", "abs_res_tol": 1e-8,
            "write_output_frequency": 5}
    resA, stateA = fused_ip_optimize(_top("torch"), dict(opts))

    class Keep(TTop):
        """Copies the checkpoint at each write-output call: the file then
        holds the previous boundary's state."""

        def write_output(self, it, x):
            if os.path.exists(ckpt):
                shutil.copy(ckpt, mid)

    _, stateB = fused_ip_optimize(Keep(n=64, block=8, dtype=F64,
                                       device="cpu"),
                                  dict(opts, ip_checkpoint_file=ckpt))
    restored = restore_state(mid, stateB)
    k = int(restored.k)
    assert 0 < k < resA["niter"]
    resC, stateC = fused_ip_optimize(_top("torch"), dict(opts),
                                     state0=restored)
    assert (resC["niter"], resC["fobj"]) == (resA["niter"], resA["fobj"])
    assert torch.equal(stateC.vars.x, stateA.vars.x)


def test_orbax_checkpoint_resumes_in_the_port(tmp_path):
    """paropt_tpu's own checkpoint (Orbax) of a FusedMMA solve, restored by
    paropt_tpu and converted, resumes in the port on JAX's uninterrupted
    trajectory."""
    from paropt_tpu.utils.checkpoint import restore_state as jrestore
    resA, stateA = _mma("jax", 10).solve(chunk=2)
    ckpt = str(tmp_path / "mma_ckpt")
    solverB = _mma("jax", 4)
    solverB.solve(chunk=2, checkpoint_path=ckpt)
    js = jrestore(ckpt, solverB._state0)
    k = int(js.k)
    assert 0 < k <= 4
    ts = convert.fused_mma_state(fields_of(js), device="cpu")
    resC, stateC = _mma("torch", 10).solve(state0=ts)
    assert int(stateC.k) == int(stateA.k)
    np.testing.assert_allclose(resC["fobj"], resA["fobj"], rtol=1e-10)
    np.testing.assert_allclose(stateC.x.numpy(), np.asarray(stateA.x),
                               rtol=0.0, atol=1e-8)


def test_mismatched_templates_raise(tmp_path):
    path = str(tmp_path / "mma.pt")
    solver = _mma("torch", 2)
    save_state(path, solver._state0)
    again = restore_state(path, solver._state0)
    assert _same(again, solver._state0)
    with pytest.raises(ValueError, match="template"):
        restore_state(path, _tr(2)._state0)            # another class
    bigger = TMMA(TTop(n=128, block=8, dtype=F64, device="cpu"),
                  dict(MMA_OPTS, mma_max_iterations=2))
    with pytest.raises(ValueError, match="shape"):
        restore_state(path, bigger._state0)
    # static fields: a BFGS state does not restore into an SR1 template
    qpath = str(tmp_path / "qn.pt")
    q = tqn.qn_init(3, 16, dtype=F64, device="cpu")
    save_state(qpath, q)
    with pytest.raises(ValueError, match="static"):
        restore_state(qpath, dataclasses.replace(q, qn_type="sr1"))
    torch.save({"x": torch.zeros(2)}, str(tmp_path / "plain.pt"))
    with pytest.raises(ValueError, match="not a paropt_torch checkpoint"):
        restore_state(str(tmp_path / "plain.pt"), q)


def test_bf16_storage_and_template_dtype(tmp_path):
    """bfloat16 ring buffers come back bfloat16 and exact; every leaf takes
    the template's dtype."""
    path = str(tmp_path / "qn.pt")
    q = tqn.qn_init(3, 16, dtype=F64, storage_dtype=torch.bfloat16,
                    device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        s = torch.tensor(rng.standard_normal(16))
        q, _, _ = tqn.qn_update(q, s, 2.0 * s)
    save_state(path, q)
    back = restore_state(path, q)
    assert back.buf.dtype == torch.bfloat16 and torch.equal(back.buf, q.buf)
    assert back.SS.dtype == F64 and torch.equal(back.SS, q.SS)
    as32 = restore_state(path, dataclasses.replace(
        q, SS=q.SS.float(), SY=q.SY.float()))
    assert as32.SS.dtype == torch.float32
