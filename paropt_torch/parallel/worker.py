"""One rank of a sharded solve (counterpart of scripts/distributed_solve.py).

Every rank runs this same program, as every MPI rank runs the reference's:
``python -m paropt_torch.parallel.worker --cases ip,qp --out DIR`` under
``torchrun --nproc-per-node=P``, or through `spawn`, which starts P ranks
on this host with the rank environment set.  Each rank joins the group
(`sharding.init_distributed`), builds a ("d",) mesh, or the ("host", "d")
mesh with ``--hosts``, places the state with `sharding.shard_tree` and runs
each case of ``--cases``:

- ``coll``: the redistributions a sharded solve makes, checked;
- ``ops``: the three kernels' DTensor rules against their plain versions;
- ``ip``: FusedIP with in-loop L-BFGS on SyntheticTopology (the main
  path), after a 2-step warm-up solve: ``--steps`` host-paced steps, then
  ``solve`` from that state to convergence; the trajectory (k, fobj, res,
  mu per step) and the final x;
- ``count``: the collective counter (`collectives`) over ``--steps``
  steps of that solve: the collectives and bytes it counts, in all and
  by kind,
  `CollectiveBytes`'s reading of them, the ``paropt.collective`` spans
  entered, and whether the steps come out bit for bit the same with the
  counter's wrappers left out;
- ``overhead``: the same solve, warm, on plain tensors and on sharded
  state in this process, and the share of the latter spent in the spmd
  mode's own work (`ModeSeconds`);
- ``ckpt``: a sharded FusedIP state saved to a
  ``torch.distributed.checkpoint`` directory and restored: the largest
  leaf difference, the placements kept, and one more step from each;
- ``qp``: the trust region's fused QP (`make_qp_model` + FusedIP) at x0;
- ``nk``: the fused Newton-Krylov phase on RandomConvexQP(256, 2, seed 5);
- ``mma``: FusedMMA on SyntheticTopology, then resumed from its state;
- ``hostip``: the host-loop InteriorPoint on a sharded design vector;
- ``fem2d``, ``fem3d``: FusedMMA on `FEMTopology` (``--fem2d``) and on
  `FEMTopology3D` (``--fem3d``), ``eigtr``: `FusedEigenTR` on a frequency
  model (``--eigtr``), each solved on plain tensors and then on sharded
  state (the FEM on x-strips, `parallel.halo`), each warm on a card: the
  trajectories, max |dx|, seconds per outer iteration, host reads, peak
  memory and qn_roll_update launches of both, and for the FEM cases the
  local entries of a fine-level CG vector and the exchanges of one
  fine-level CG iteration.

Each rank writes ``rank{r}.json`` (its case results, the scalars every
rank read, the kernels' launch counts) and rank 0 writes each case's final
vectors as ``{case}_{name}.npy``.  The worker imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from . import collectives

__all__ = ["spawn", "main", "QP_N", "MMA_N", "HOST_IP_N", "FEM2D", "FEM3D",
           "EIGTR", "EIG_OPTS"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(nproc: int, args, timeout: float = 600.0, env=None,
          cwd=None) -> None:
    """Start ``nproc`` ranks of this worker on this host (rank r with
    ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` 127.0.0.1 and
    a free ``MASTER_PORT``) and wait for all of them; raise with the error
    output of a rank that fails.  A rank still running at ``timeout`` is
    killed, and every rank is ended before this returns."""
    port = _free_port()
    procs = []
    for r in range(nproc):
        e = dict(os.environ if env is None else env)
        e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nproc),
                 LOCAL_WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paropt_torch.parallel.worker",
             *map(str, args)], env=e, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.time() + timeout
    failed = []
    try:
        for r, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
                failed.append((r, f"timed out after {timeout} s\n{err}"))
                continue
            if p.returncode != 0:
                failed.append((r, f"exit {p.returncode}\n{out[-2000:]}"
                                  f"\n{err[-6000:]}"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        r, msg = failed[0]
        raise RuntimeError(f"rank {r} of {nproc} failed: {msg}")


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


class _Ctx:
    """What every case needs: the mesh, the dtype, the device, the
    output."""

    def __init__(self, args, mesh):
        self.args = args
        self.mesh = mesh
        self.dtype = getattr(torch, args.dtype)
        self.device = args.device
        self.rank = torch.distributed.get_rank()

    def whole(self, t) -> np.ndarray:
        """A tensor as one numpy array on every rank (a collective)."""
        from .sharding import is_sharded
        if is_sharded(t):
            t = t.full_tensor()
        return t.detach().cpu().numpy()

    def save(self, case: str, **arrays) -> None:
        """Gather every array on every rank; rank 0 writes them."""
        whole = {k: self.whole(v) for k, v in arrays.items()}
        if self.rank == 0:
            for k, v in whole.items():
                np.save(os.path.join(self.args.out, f"{case}_{k}.npy"), v)


def _fused_ip(ctx, n, msub, tol, max_iters=400):
    from .. import ip_fused
    from ..models.topology import SyntheticTopology
    from ..ops import qn as qnmod
    prob = SyntheticTopology(n=n, block=8, dtype=ctx.dtype,
                             device=ctx.device)
    opts = ip_fused.FusedIPOptions(
        use_quasi_newton_update=True, abs_res_tol=tol,
        max_major_iters=max_iters,
        iterative_refinement_steps=ctx.args.refine)
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), n,
                             prob.ncon, prob.nwcon, prob.nwblock, opts,
                             dtype=ctx.dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=ctx.dtype)
    qn0 = qnmod.qn_init(msub, n, dtype=ctx.dtype, device=ctx.device)
    return fused, data, x0, qn0


def _row(st) -> dict:
    return {"k": int(st.k), "fobj": float(st.fobj),
            "res": float(st.res_norm), "mu": float(st.mu)}


def case_ip(ctx) -> dict:
    """The main path: ``--steps`` steps, then the solve from there; timed
    after a 2-step warm-up solve, as chip_smoke.py's phase 4 times its
    unsharded solve."""
    from ..ops import kernels
    from .sharding import shard_tree
    a = ctx.args
    fused, data, x0, qn0 = _fused_ip(ctx, a.n, a.msub, a.tol)
    ds = shard_tree(data, ctx.mesh, a.n)
    x0, qn0 = shard_tree((x0, qn0), ctx.mesh, a.n)
    fused.solve(x0, ds, (), qn0, None, max_iters=2)
    _sync(ctx)
    kernels.reset_launches()
    reads0 = fused.syncs.count
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    traj = []
    with CollectiveBytes() as coll:
        st = fused.init(x0, ds, (), qn0, None)
        for _ in range(a.steps):
            st = fused.step(st, ds, (), None)
            traj.append(_row(st))
        st = fused.solve(None, ds, (), state0=st,
                         on_chunk=lambda s: traj.append(_row(s)))
        _sync(ctx)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ctx.save("ip", x=st.vars.x)
    peak = (torch.cuda.max_memory_allocated() if ctx.device == "cuda"
            else None)
    return {"trajectory": traj, "converged": bool(st.converged),
            "seconds": seconds, "reads": fused.syncs.count - reads0,
            "collectives": coll.calls, "collective_bytes": coll.bytes,
            "peak_bytes": peak,
            "bytes_gathered": fused.syncs.bytes_gathered,
            "launches": launches, "placements": {
                "x": str(st.vars.x.placements), "zw": _placement(st.vars.zw),
                "qn.buf": str(st.qn.buf.placements),
                "A": str(st.A.placements)}}


def case_count(ctx) -> dict:
    """The collective counter over ``--steps`` steps of the main path's
    sharded solve (see the module docstring)."""
    from .sharding import shard_tree
    a = ctx.args
    fused, data, x0, qn0 = _fused_ip(ctx, a.n, a.msub, a.tol)
    ds = shard_tree(data, ctx.mesh, a.n)
    xs, qs = shard_tree((x0, qn0), ctx.mesh, a.n)

    def solve(*args):
        return fused.solve(*args, max_iters=a.steps)

    spans = []
    span = collectives.span
    collectives.span = lambda name: spans.append(name) or span(name)
    collectives.reset()
    try:
        with CollectiveBytes() as coll:
            st = solve(xs, ds, (), qs, None)
    finally:
        collectives.span = span
    counted = dict(collectives.COUNTS)
    kinds = {k: list(v) for k, v in collectives.BY_KIND.items()}
    collectives.reset()
    saved = collectives.counting
    collectives.counting = contextlib.nullcontext
    try:
        bare = solve(xs, ds, (), qs, None)
        uncounted = dict(collectives.COUNTS)
    finally:
        collectives.counting = saved
    same = all(ctx.whole(u).tobytes() == ctx.whole(v).tobytes()
               for u, v in zip(_leaves(st), _leaves(bare)))
    return {"calls": counted["calls"], "bytes": counted["bytes"],
            "kinds": kinds,
            "reading": {"calls": coll.calls, "bytes": coll.bytes},
            "spans": spans.count(collectives.SPAN),
            "uncounted": uncounted, "bit_equal": same,
            "installed_after": collectives.installed(), "k": int(st.k)}


def case_overhead(ctx) -> dict:
    """The main path's solve, each run warm (a 2-step solve first) and
    timed alone: on plain tensors, then on sharded state with the seconds
    the spmd mode spends outside the torch functions it wraps
    (`ModeSeconds`).  The rest of the sharded run's excess over the plain
    one lies outside the mode (DTensor's dispatch and collectives, the
    gathered host reads) and is not split here."""
    from .sharding import shard_tree
    a = ctx.args
    fused, data, x0, qn0 = _fused_ip(ctx, a.n, a.msub, a.tol)
    ds = shard_tree(data, ctx.mesh, a.n)
    xs, qs = shard_tree((x0, qn0), ctx.mesh, a.n)
    out = {}
    for name, args in (("plain", (x0, data, (), qn0, None)),
                       ("sharded", (xs, ds, (), qs, None))):
        fused.solve(*args, max_iters=2)
        _sync(ctx)
        with ModeSeconds() as mode:
            t0 = time.perf_counter()
            st = fused.solve(*args)
            _sync(ctx)
            seconds = time.perf_counter() - t0
        out[name] = {"seconds": seconds, "iters": int(st.k),
                     "mode_seconds": mode.seconds, "mode_calls": mode.calls}
    return out


class ModeSeconds:
    """Times the spmd mode's own work (`sharding._SettleReductions`) while
    it is entered: per torch function, the seconds spent in the mode
    outside the function itself (its dispatch, its settle walk and the
    all-reduces of pending sums that walk issues)."""

    def __init__(self):
        self.seconds = 0.0
        self.calls = 0

    def __enter__(self):
        from .sharding import _SettleReductions
        self._saved = _SettleReductions.mode
        base = type(_SettleReductions.make())
        outer = self

        class Timed(base):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                inner = 0.0

                def timed(*a, **k):
                    nonlocal inner
                    t1 = time.perf_counter()
                    try:
                        return func(*a, **k)
                    finally:
                        inner += time.perf_counter() - t1

                t0 = time.perf_counter()
                out = super().__torch_function__(timed, types, args, kwargs)
                outer.seconds += time.perf_counter() - t0 - inner
                outer.calls += 1
                return out

        _SettleReductions.mode = Timed
        return self

    def __exit__(self, *exc):
        from .sharding import _SettleReductions
        _SettleReductions.mode = self._saved


class CollectiveBytes:
    """The collectives this rank issued while entered and the bytes of
    their local inputs (what the rank hands to each), read on exit from
    the program's one counter, `collectives.COUNTS`, whose wrappers stay
    installed while entered; and the x-strips' exchanges (`halo.record`):
    ``halo`` lists each one's (helper, elements sent to each peer,
    peers)."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0
        self.halo = []

    def add(self, kind, elements, peers):
        self.halo.append((kind, elements, peers))

    def __enter__(self):
        from . import halo
        halo.RECORDERS.append(self)
        self._counting = collectives.counting()
        self._start = dict(self._counting.__enter__())
        return self

    def __exit__(self, *exc):
        from . import halo
        self.calls = collectives.COUNTS["calls"] - self._start["calls"]
        self.bytes = collectives.COUNTS["bytes"] - self._start["bytes"]
        self._counting.__exit__(*exc)
        halo.RECORDERS.remove(self)


def _placement(t) -> str:
    from .sharding import is_sharded
    return str(t.placements) if is_sharded(t) else "local"


def _sync(ctx) -> None:
    if ctx.device != "cpu" and torch.cuda.is_available():
        torch.cuda.synchronize()
    torch.distributed.barrier()


def case_ckpt(ctx) -> dict:
    """A sharded fused state through a DCP directory and back."""
    from ..utils.checkpoint import restore_state, save_state
    from .sharding import shard_tree
    a = ctx.args
    fused, data, x0, qn0 = _fused_ip(ctx, a.n, a.msub, a.tol)
    st = shard_tree(fused.init(x0, data, (), qn0, None), ctx.mesh, a.n)
    ds = shard_tree(data, ctx.mesh, a.n)
    for _ in range(3):
        st = fused.step(st, ds, (), None)
    path = os.path.join(a.out, "ckpt_state")
    _sync(ctx)
    t0 = time.perf_counter()
    save_state(path, st)
    _sync(ctx)
    write_s = time.perf_counter() - t0
    template = shard_tree(fused.init(x0, data, (), qn0, None), ctx.mesh,
                          a.n)
    back = restore_state(path, template)
    same_place = _same_placements(st, back)
    diff = _tree_maxdiff(ctx, st, back)
    one = fused.step(st, ds, (), None)
    two = fused.step(back, ds, (), None)
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    return {"maxdiff": diff, "placements_kept": same_place,
            "step_maxdiff": _tree_maxdiff(ctx, one, two),
            "bytes": size, "write_seconds": write_s}


def _leaves(tree):
    from .sharding import _leaves as leaves
    return leaves(tree)


def _spec(t) -> tuple:
    """A leaf's placements, a plain tensor (a whole copy on every rank)
    counting as replicated."""
    from torch.distributed.tensor import Replicate
    from .sharding import is_sharded
    return tuple(t.placements) if is_sharded(t) else (Replicate(),)


def _same_placements(a, b) -> bool:
    def norm(spec):
        return tuple(p for p in spec if p != spec[0]) or spec[:1]
    return all(norm(_spec(x)) == norm(_spec(y))
               for x, y in zip(_leaves(a), _leaves(b)))


def _tree_maxdiff(ctx, a, b) -> float:
    """The largest |a - b| over two trees' leaves, on every rank."""
    out = 0.0
    for x, y in zip(_leaves(a), _leaves(b)):
        if x.numel() == 0:
            continue
        x, y = ctx.whole(x), ctx.whole(y)
        if x.dtype == bool:
            out = max(out, float(np.any(x != y)))
        else:
            out = max(out, float(np.max(np.abs(x.astype(np.float64)
                                               - y.astype(np.float64)))))
    return out


def case_qp(ctx) -> dict:
    """The TR's fused QP at x0 on sharded data, params and compact form
    (`tr_qp_inputs` builds the inputs the tests use unsharded)."""
    from .sharding import shard_tree
    tr, p0, data, params = tr_qp_inputs(QP_N, ctx.dtype, ctx.device)
    ds = shard_tree(data, ctx.mesh, QP_N)
    ps = shard_tree(params, ctx.mesh, QP_N)
    st = tr._fused_qp.solve(shard_tree(p0, ctx.mesh, QP_N), ds, ps,
                            compact=(ps.b0, ps.Z, ps.M))
    ctx.save("qp", x=st.vars.x, zw=st.vars.zw)
    return {"k": int(st.k), "converged": bool(st.converged)}


# the sizes of the qp, mma and hostip cases (the tests import them)
QP_N = 2048
MMA_N = 512
HOST_IP_N = 1024


def tr_qp_inputs(n, dtype, device):
    """(TrustRegion, p0, data, params) of the first QP solve of the trust
    region on SyntheticTopology(n): the inputs of the JAX package's
    sharded-QP test (tests/test_sharding.py:297-331)."""
    from ..models.topology import SyntheticTopology
    from ..tr import TrustRegion
    prob = SyntheticTopology(n=n, block=8, dtype=dtype, device=device)
    tr = TrustRegion(prob, {"output_file": None, "tr_output_file": None,
                            "tr_max_iterations": 1,
                            "dtype": str(dtype).split(".")[-1]})
    tr.subproblem.init_model(tr.tr_size)
    tr._build_fused()
    gam = torch.as_tensor(tr.penalty_gamma, dtype=dtype, device=device)
    idx = torch.arange(prob.ncon, device=device)
    gamma_s = torch.where(idx < prob.ninequality, 0.0, gam)
    data = tr._fused_data(gamma_s, gam, tr.options["penalty_gamma"])
    params = tr._qp_params()
    p0 = 0.5 * (tr.subproblem.lk + tr.subproblem.uk)
    return tr, p0, data, params


def nk_solver(dtype, device):
    """(FusedIP, data, x0, qn0) of the fused Newton-Krylov case:
    RandomConvexQP(256, 2, seed 5), GMRES(10) from nk_switch_tol 1."""
    from .. import ip_fused
    from ..models.analytic import RandomConvexQP
    from ..ops import qn as qnmod
    prob = RandomConvexQP(n=256, ncon=2, seed=5, dtype=dtype, device=device)
    opts = ip_fused.FusedIPOptions(
        use_quasi_newton_update=True, abs_res_tol=1e-9, max_major_iters=300,
        use_hvec_product=True, gmres_subspace_size=10, nk_switch_tol=1.0)
    fused = ip_fused.FusedIP(ip_fused.model_from_problem(prob), prob.nvars,
                             prob.ncon, prob.nwcon, prob.nwblock, opts,
                             dtype=dtype)
    data, x0 = ip_fused.data_template_from_problem(prob, dtype=dtype)
    qn0 = qnmod.qn_init(8, prob.nvars, dtype=dtype, device=device)
    return fused, data, x0, qn0


def case_nk(ctx) -> dict:
    """The fused NK phase, host-paced so that its engagement shows."""
    from .sharding import shard_tree
    fused, data, x0, qn0 = nk_solver(ctx.dtype, ctx.device)
    n = x0.shape[0]
    ds = shard_tree(data, ctx.mesh, n)
    st = fused.init(shard_tree(x0, ctx.mesh, n), ds, (),
                    shard_tree(qn0, ctx.mesh, n), None)
    arms = []
    for _ in range(fused.opts.max_major_iters):
        st = fused.step(st, ds, (), None)
        arms.append(int(st.gmres_iters))
        if bool(st.converged):
            break
    ctx.save("nk", x=st.vars.x)
    return {"k": int(st.k), "converged": bool(st.converged),
            "gmres_iters": arms}


MMA_OPTS = {"mma_max_iterations": 4, "mma_output_file": None,
            "dtype": "float64"}


def case_mma(ctx) -> dict:
    """FusedMMA from a sharded initial state, then resumed from the final
    one for as many outer iterations again."""
    from ..mma import FusedMMA
    from ..models.topology import SyntheticTopology
    from .sharding import shard_tree
    n = MMA_N
    solver = FusedMMA(SyntheticTopology(n=n, block=8, dtype=ctx.dtype,
                                        device=ctx.device),
                      dict(MMA_OPTS, dtype=str(ctx.dtype).split(".")[-1]))
    res, st = solver.solve(state0=shard_tree(solver._state0, ctx.mesh, n))
    k0 = torch.zeros_like(st.k)
    res2, st2 = solver.solve(state0=dataclasses.replace(st, k=k0))
    ctx.save("mma", x=st2.x)
    return {"fobj": res["fobj"], "niter": res["niter"],
            "fobj_resumed": res2["fobj"], "niter_resumed": res2["niter"]}


HOST_IP_OPTS = {"output_file": None, "abs_res_tol": 1e-4,
                "max_major_iters": 100}


def case_hostip(ctx) -> dict:
    """The host-loop InteriorPoint on a design vector sharded over the
    mesh: the problem hands out a DTensor x0."""
    from ..ip import InteriorPoint
    from ..models.topology import SyntheticTopology
    from .sharding import shard_design
    n = HOST_IP_N
    prob = SyntheticTopology(n=n, block=8, dtype=ctx.dtype,
                             device=ctx.device)
    x0, lb, ub = prob.get_vars_and_bounds()
    prob.get_vars_and_bounds = lambda: (shard_design(x0, ctx.mesh), lb, ub)
    ip = InteriorPoint(prob, dict(HOST_IP_OPTS,
                                  dtype=str(ctx.dtype).split(".")[-1]))
    res = ip.optimize()
    path = os.path.join(ctx.args.out, "hostip_ckpt")
    ip.write_solution_file(path)
    back = InteriorPoint(prob, dict(HOST_IP_OPTS,
                                    dtype=str(ctx.dtype).split(".")[-1]))
    back.read_solution_file(path)
    ctx.save("hostip", x=res["x"])
    return {"niter": res["niter"], "fobj": float(res["fobj"]),
            "converged": bool(res["converged"]),
            "is_dir": os.path.isdir(path),
            "ckpt_maxdiff": _tree_maxdiff(ctx, ip.vars, back.vars),
            "ckpt_placements_kept": _same_placements(ip.vars, back.vars),
            "ckpt_mu": back.mu == ip.mu}


def op_inputs(n: int, K: int, B: int, m: int, dtype, seed: int = 0):
    """Seeded operands of the three kernels at design size n (the
    blocked_t view [8, n/8]): the roll's buf [2m, n], s, y and upd; the
    quasi-definite apply's dinv, cwinv, vals, bx [K, 8, n/8], bw [K, n/8];
    phi_gram's stack [B - 1 rows, A's row]."""
    rng = np.random.default_rng(seed)
    k, W = 8, n // 8

    def t(*shape, lo=-1.0):
        return torch.as_tensor(rng.uniform(lo, 1.0, shape), dtype=dtype)

    return {"buf": t(2 * m, n), "s": t(n), "y": t(n),
            "upd": torch.tensor(True),
            "dinv2": t(k, W, lo=0.5), "cwinv": t(W, lo=0.5),
            "vals_t": t(k, W), "bx3": t(K, k, W), "bw2": t(K, W),
            "zq": t(B - 1, k, W), "a3": t(1, k, W)}


def run_ops(ops, kernels):
    """The three wrappers on ``ops`` (plain tensors or DTensors placed as
    the main path places them)."""
    buf, dots = kernels.qn_roll_update(ops["buf"], ops["s"], ops["y"],
                                       ops["upd"])
    yx, yw = kernels.quasi_def_apply(ops["dinv2"], ops["cwinv"],
                                     ops["vals_t"], ops["bx3"], ops["bw2"])
    gx, gw, gram = kernels.phi_gram(ops["dinv2"], ops["cwinv"],
                                    ops["vals_t"], ops["zq"], None,
                                    ops["a3"])
    return {"buf": buf, "dots": dots, "yx": yx, "yw": yw, "gx": gx,
            "gw": gw, "gram": gram}


def place_ops(ops, mesh):
    """The operands as the main path holds them: n-sized arrays and the
    [.., k, nwcon] views of design vectors in row shards, the rest
    replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from .sharding import _place
    dims = {"buf": 1, "s": 0, "y": 0, "dinv2": 0, "bx3": 1, "zq": 1,
            "a3": 1}
    return {k: _place(v, mesh, [Shard(dims[k]) if k in dims
                                else Replicate()] * mesh.ndim)
            for k, v in ops.items()}


def case_ops(ctx) -> dict:
    """Each kernel's DTensor rule against its plain version on the whole
    operands: the largest difference of every output, and the error of a
    layout the rank count cannot split."""
    from ..ops import kernels
    dev = ctx.device
    ops = {k: v.to(dev) for k, v in op_inputs(ctx.args.n, 1, 21, 10,
                                             ctx.dtype).items()}
    kernels.reset_launches()
    got = run_ops(place_ops(ops, ctx.mesh), kernels)
    launches = dict(kernels.LAUNCHES)
    want = run_ops(ops, kernels)
    diff = {k: float(np.max(np.abs(ctx.whole(got[k])
                                   - want[k].cpu().numpy())))
            for k in want}
    scale = {k: float(torch.max(torch.abs(v))) for k, v in want.items()}
    placed = {k: _placement(v) for k, v in got.items()}
    bad = {k: v.to(dev) for k, v in op_inputs(8 * 6, 1, 3, 2,
                                             ctx.dtype).items()}
    try:
        run_ops(place_ops(bad, ctx.mesh), kernels)
        split_error = None
    except ValueError as exc:
        split_error = str(exc)
    return {"maxdiff": diff, "scale": scale, "placements": placed,
            "launches": launches, "split_error": split_error}


def case_coll(ctx) -> dict:
    """The redistributions a sharded solve makes (a sum all-reduced, a
    shard gathered, row shards of a [8, n/8] view moved to column shards),
    each against its value on one rank: the largest error of each."""
    from torch.distributed.tensor import Replicate, Shard
    from .sharding import _place
    n = ctx.args.n
    whole = torch.arange(n, dtype=ctx.dtype, device=ctx.device) / n
    x = _place(whole, ctx.mesh, [Shard(0)] * ctx.mesh.ndim)
    rep = [Replicate()] * ctx.mesh.ndim
    cols = x.reshape(8, n // 8).redistribute(ctx.mesh,
                                             [Shard(1)] * ctx.mesh.ndim)
    return {"sum": float(abs(torch.sum(x).redistribute(ctx.mesh, rep)
                             .to_local() - torch.sum(whole))),
            "gather": float(torch.max(torch.abs(
                x.redistribute(ctx.mesh, rep).to_local() - whole))),
            "to_columns": float(torch.max(torch.abs(
                cols.full_tensor() - whole.reshape(8, n // 8))))}


# the FEM and eigen cases' sizes (the CPU tests'; a chip run passes its
# own): nex, ney[, nez], cg_iters, outer iterations; the eigen TR's nex,
# ney[, nez], N, cg_iters, lobpcg_iters, outer iterations
FEM2D = (16, 8, 25, 8)
FEM3D = (8, 4, 4, 20, 5)
EIGTR = (8, 4, 3, 25, 40, 6)
# the eigen TR's options (tests/test_sharding.py:449-464)
EIG_OPTS = {"tr_output_file": None, "output_file": None,
            "tr_init_size": 0.05, "tr_max_size": 0.2, "tr_min_size": 1e-6,
            "abs_res_tol": 1e-8, "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0}


def _case_spec(ctx, text):
    """A FEM case's sizes "a,b,...", with ":float32" or ":float64" at the
    end to override ``--dtype``: (dtype, sizes)."""
    sizes, _, dtype = str(text).partition(":")
    return (getattr(torch, dtype) if dtype else ctx.dtype,
            tuple(int(v) for v in sizes.split(",")))


def _outer_rows(step, state, iters, syncs, fields):
    """Up to ``iters`` outer iterations of ``step`` from ``state``, one host
    read of each iteration's (k, fobj, infeas, l1) and converged flag."""
    from .sharding import spmd

    @spmd
    def run(state):
        rows = []
        for _ in range(iters):
            state = step(state)
            k, f, inf, l1, done = syncs.values(
                *(getattr(state, a) for a in fields))
            rows.append({"k": int(k), "fobj": f, "infeas": inf, "l1": l1})
            if done:
                break
        return state, rows

    return run(state)


def _timed_runs(ctx, name, solve, state0, nvars):
    """``solve(state0, limit)`` -> (rows, x, host reads, extras) on plain
    tensors and on sharded state, each warm on a card (one outer iteration
    first): {"plain": ..., "sharded": ...} with each run's trajectory,
    seconds per outer iteration, host reads, peak memory, kernel launches
    and extras, and max |dx| between their x."""
    from ..ops import kernels
    from .sharding import shard_tree
    out, xs = {}, {}
    for run in ("plain", "sharded"):
        st0 = state0 if run == "plain" else shard_tree(state0, ctx.mesh,
                                                       nvars)
        if ctx.device == "cuda":
            solve(st0, 1)
        _sync(ctx)
        kernels.reset_launches()
        if ctx.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows, x, reads, extra = solve(st0, None)
        _sync(ctx)
        seconds = time.perf_counter() - t0
        xs[run] = ctx.whole(x)
        out[run] = {"trajectory": rows, "iterations": len(rows),
                    "seconds_per_iteration": seconds / max(len(rows), 1),
                    "reads": reads, "launches": dict(kernels.LAUNCHES),
                    "peak_bytes": (torch.cuda.max_memory_allocated()
                                   if ctx.device == "cuda" else None),
                    **extra}
    out["max_dx"] = float(np.max(np.abs(xs["plain"] - xs["sharded"])))
    ctx.save(name, x=torch.as_tensor(xs["sharded"]))
    return out


def _mma_runs(ctx, name, prob, iters):
    from ..mma import FusedMMA
    solver = FusedMMA(prob, {"mma_max_iterations": iters,
                             "mma_output_file": None,
                             "dtype": str(prob._dtype).split(".")[-1]})

    def solve(st0, limit):
        reads = solver.syncs.count
        st, rows = _outer_rows(solver._step, st0, limit or iters,
                               solver.syncs, ("k", "fobj", "infeas", "l1",
                                              "converged"))
        return rows, st.x, solver.syncs.count - reads, {}

    return _timed_runs(ctx, name, solve, solver._state0, prob.nvars)


def _locality(ctx, prob, row):
    """{"local": ...}: a fine-level CG vector's entries on this rank's
    strip, and the strip's exchanges in one fine-level CG iteration (the
    difference between solves of 2 and of 1 CG iterations), which differ
    between a middle rank and an end one."""
    from .sharding import shard_design
    x0, _, _ = prob.get_vars_and_bounds()
    view = prob._strip_view(ctx.mesh)
    xl = shard_design(x0, ctx.mesh).to_local()
    E = view._simp(view._filter(xl))
    logs, u = [], None
    for iters in (1, 2):
        view.cg_iters = iters
        with CollectiveBytes() as coll:
            u = view._solve(E)
        logs.append(coll.halo)
    extra = logs[1][len(logs[0]):]
    kinds = {}
    for kind, _, _ in extra:
        kinds[kind] = kinds.get(kind, 0) + 1
    gathers = [e for k, e, _ in logs[1] if k == "gather_rows"]
    return {"local": {
        "fine_cg_entries": int(u.numel()), "node_row_entries": row,
        "gather_point": view._mg_gather,
        "per_cg_iteration": {
            "collectives": len(extra),
            "elements": sum(e * p for _, e, p in extra),
            "max_elements_per_peer": max((e for _, e, _ in extra),
                                         default=0),
            "kinds": kinds},
        "largest_gather": max(gathers, default=0)}}


def case_fem2d(ctx) -> dict:
    """FusedMMA on FEMTopology(nex, ney, cg_iters, mgcg), plain and on
    x-strips."""
    from ..models.fem_topology import FEMTopology
    dtype, (nex, ney, cg, iters) = _case_spec(ctx, ctx.args.fem2d)
    prob = FEMTopology(nex, ney, cg_iters=cg, solver="mgcg", dtype=dtype,
                       device=ctx.device)
    out = _mma_runs(ctx, "fem2d", prob, iters)
    out.update(_locality(ctx, prob, 2 * (ney + 1)))
    out["uneven_error"] = _uneven_error(ctx, ney, dtype)
    return out


def _uneven_error(ctx, ney, dtype):
    """The error of an evaluation on 18 element rows, which P ranks must
    divide (None where they do)."""
    from ..models.fem_topology import FEMTopology
    from .sharding import shard_design
    prob = FEMTopology(18, ney, cg_iters=2, dtype=dtype, device=ctx.device)
    x0, _, _ = prob.get_vars_and_bounds()
    try:
        prob.eval_obj_con(shard_design(x0, ctx.mesh))
    except ValueError as exc:
        return str(exc)
    return None


def case_fem3d(ctx) -> dict:
    """FusedMMA on FEMTopology3D(nex, ney, nez, cg_iters, mgcg), plain and
    on x-slabs."""
    from ..models.fem_topology3d import FEMTopology3D
    dtype, (nex, ney, nez, cg, iters) = _case_spec(ctx, ctx.args.fem3d)
    prob = FEMTopology3D(nex, ney, nez, cg_iters=cg, solver="mgcg",
                         dtype=dtype, device=ctx.device)
    out = _mma_runs(ctx, "fem3d", prob, iters)
    out.update(_locality(ctx, prob, 3 * (ney + 1) * (nez + 1)))
    return out


def case_eigtr(ctx) -> dict:
    """FusedEigenTR on FrequencyTopology (``--eigtr`` of 6 values) or
    FrequencyTopology3D (7 values), mgcg, with ``--eig-options``, plain
    and on x-strips; with each run's LOBPCG block iterations and its final
    KS constraint value."""
    from ..models.fem_frequency import FrequencyTopology, FrequencyTopology3D
    dtype, (*mesh, N, cg, lob, iters) = _case_spec(ctx, ctx.args.eigtr)
    model = FrequencyTopology if len(mesh) == 2 else FrequencyTopology3D
    prob = model(*mesh, N=N, cg_iters=cg, solver="mgcg", lobpcg_iters=lob,
                 dtype=dtype, device=ctx.device)
    solver = prob.build_fused_tr(dict(json.loads(ctx.args.eig_options),
                                      tr_max_iterations=iters,
                                      dtype=str(dtype).split(".")[-1]))

    def solve(st0, limit):
        reads = solver.syncs.count
        n0 = len(prob.lobpcg_iters_log)
        st, rows = _outer_rows(solver._step, st0, limit or iters,
                               solver.syncs, ("k", "fk", "infeas", "l1",
                                              "converged"))
        return rows, st.xk, solver.syncs.count - reads, {
            "lobpcg": list(prob.lobpcg_iters_log[n0:]),
            "ks": float(ctx.whole(st.ck)[0])}

    return _timed_runs(ctx, "eigtr", solve, solver._state0, prob.nvars)


CASES = {"coll": case_coll, "ops": case_ops, "ip": case_ip,
         "count": case_count,
         "overhead": case_overhead, "ckpt": case_ckpt, "qp": case_qp,
         "nk": case_nk, "mma": case_mma, "hostip": case_hostip,
         "fem2d": case_fem2d, "fem3d": case_fem3d, "eigtr": case_eigtr}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="ip",
                    help=f"comma-separated, of {sorted(CASES)}")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"))
    ap.add_argument("--hosts", type=int, default=0,
                    help="a (hosts, ranks/hosts) hybrid mesh; 0: 1-D")
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--msub", type=int, default=10)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--steps", type=int, default=5,
                    help="ip: host-paced steps before the solve")
    ap.add_argument("--refine", type=int, default=1,
                    help="ip, ckpt: iterative refinement steps")
    ap.add_argument("--fem2d", default=",".join(map(str, FEM2D)),
                    help="fem2d: nex,ney,cg_iters,outer iterations[:dtype]")
    ap.add_argument("--fem3d", default=",".join(map(str, FEM3D)),
                    help="fem3d: nex,ney,nez,cg_iters,outer iterations"
                    "[:dtype]")
    ap.add_argument("--eigtr", default=",".join(map(str, EIGTR)),
                    help="eigtr: nex,ney[,nez],N,cg_iters,lobpcg_iters,"
                    "outer iterations[:dtype]")
    ap.add_argument("--eig-options", default=json.dumps(EIG_OPTS),
                    help="eigtr: the solver's options, a JSON object")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    from . import sharding
    sharding.init_distributed("gloo" if args.device == "cpu" else "nccl")
    os.makedirs(args.out, exist_ok=True)
    try:
        mesh = (sharding.hybrid_design_mesh(args.hosts,
                                            device_type=args.device)
                if args.hosts else sharding.design_mesh(args.device))
        ctx = _Ctx(args, mesh)
        result = {"rank": ctx.rank,
                  "world_size": torch.distributed.get_world_size(),
                  "backend": torch.distributed.get_backend(),
                  "mesh": list(mesh.shape),
                  "mesh_dim_names": list(mesh.mesh_dim_names)}
        for name in args.cases.split(","):
            t0 = time.perf_counter()
            result[name] = CASES[name](ctx)
            result[name]["case_seconds"] = time.perf_counter() - t0
        with open(os.path.join(args.out, f"rank{ctx.rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
