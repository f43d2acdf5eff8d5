"""The reference's fill-callback surface (`paropt_torch.compat`) against
paropt_tpu.compat: every case of tests/test_compat.py, each user problem
written once against a ``ParOpt`` module and run through both packages
(the port on the CPU, float64).  Solves take the same iteration counts,
with fobj within 1e-10 relative (plus 1e-14 absolute where a solve ends at
fobj ~ 0); the accessors, the option introspection, the checkpoint tuple
and the direct-driven quasi-Newton objects agree as stated per case.

The LSR1 object case is held to the optimum only: its iteration count is
decided by roundoff (a 1e-15 move of the start changes paropt_tpu's own
count from 37 to 36, 38 or 42; ROADMAP queue 3, SR1)."""

import numpy as np
import pytest
import torch

from paropt_tpu import compat as JParOpt
from paropt_torch import compat as TParOpt

torch.set_num_threads(1)

PKGS = {"jax": JParOpt, "torch": TParOpt}


def _kw(ParOpt):
    """The port's problems run on the CPU here (the card by default)."""
    return {"device": "cpu"} if ParOpt is TParOpt else {}


def rosenbrock(ParOpt, x0=(-1.5, -1.0)):
    """`examples/rosenbrock/rosenbrock.py`, the import changed."""

    class Rosenbrock(ParOpt.Problem):
        def __init__(self):
            self.nvars = 2
            self.ncon = 1
            super(Rosenbrock, self).__init__(None, nvars=self.nvars,
                                             ncon=self.ncon, **_kw(ParOpt))

        def getVarsAndBounds(self, x, lb, ub):
            x[:] = np.array(x0)
            lb[:] = -2.0
            ub[:] = 2.0

        def evalObjCon(self, x):
            fail = 0
            con = np.zeros(1)
            fobj = 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
            con[0] = x[0] + x[1] + 5.0
            return fail, fobj, con

        def evalObjConGradient(self, x, g, A):
            fail = 0
            g[0] = -400.0 * (x[1] - x[0] ** 2) * x[0] - 2.0 * (1.0 - x[0])
            g[1] = 200.0 * (x[1] - x[0] ** 2)
            A[0][0] = 1.0
            A[0][1] = 1.0
            return fail

    return Rosenbrock()


def electron(ParOpt, n=6):
    """The CSR sparse-constraint surface (`examples/COPS/electron/
    electron.py` structure)."""

    class ElectronCompat(ParOpt.Problem):
        def __init__(self):
            self.n = n
            rowp = [0]
            cols = []
            for i in range(n):
                cols.extend([i, n + i, 2 * n + i])
                rowp.append(len(cols))
            super().__init__(None, nvars=3 * n, num_sparse_constraints=n,
                             num_sparse_inequalities=0, rowp=rowp,
                             cols=cols, **_kw(ParOpt))

        def getVarsAndBounds(self, x, lb, ub):
            np.random.seed(0)
            alpha = np.random.uniform(0.0, 2 * np.pi, n)
            beta = np.random.uniform(-np.pi, np.pi, n)
            x[:n] = np.cos(beta) * np.cos(alpha)
            x[n:2 * n] = np.cos(beta) * np.sin(alpha)
            x[2 * n:] = np.sin(beta)
            lb[:] = -10.0
            ub[:] = 10.0

        def _pairs(self, x):
            pts = np.stack([x[:n], x[n:2 * n], x[2 * n:]], axis=1)
            iu = np.triu_indices(n, k=1)
            d = pts[iu[0]] - pts[iu[1]]
            return iu, pts, (d * d).sum(axis=1)

        def evalSparseObjCon(self, x, sparse_con):
            _, _, dsq = self._pairs(x)
            fobj = np.sum(np.maximum(dsq, 1e-10) ** -0.5)
            sparse_con[:] = 1.0 - (x[:n] ** 2 + x[n:2 * n] ** 2
                                   + x[2 * n:] ** 2)
            return 0, fobj, []

        def evalSparseObjConGradient(self, x, g, A, data):
            iu, pts, dsq = self._pairs(x)
            dsq = np.maximum(dsq, 1e-10)
            coef = -(dsq ** -1.5)
            grad = np.zeros((n, 3))
            diff = pts[iu[0]] - pts[iu[1]]
            for k in range(len(iu[0])):
                grad[iu[0][k]] += coef[k] * diff[k]
                grad[iu[1][k]] -= coef[k] * diff[k]
            g[:n] = grad[:, 0]
            g[n:2 * n] = grad[:, 1]
            g[2 * n:] = grad[:, 2]
            for i in range(n):
                data[3 * i] = -2.0 * x[i]
                data[3 * i + 1] = -2.0 * x[n + i]
                data[3 * i + 2] = -2.0 * x[2 * n + i]
            return 0

    return ElectronCompat()


def sparse_rosenbrock(ParOpt):
    """The block-callback sparse surface (`examples/sparse/
    sparse_rosenbrock.py`, the import changed)."""

    class SparseRosenbrockCompat(ParOpt.Problem):
        def __init__(self):
            super().__init__(None, nvars=2, ncon=0, nwcon=1, nwblock=1,
                             **_kw(ParOpt))

        def getVarsAndBounds(self, x, lb, ub):
            x[:] = np.array([-1.5, -1.0])
            lb[:] = -2.0
            ub[:] = 2.0

        def evalObjCon(self, x):
            fobj = 100.0 * (x[1] - x[0] ** 2) ** 2 + (1.0 - x[0]) ** 2
            return 0, fobj, np.zeros(0)

        def evalObjConGradient(self, x, g, A):
            g[0] = -400.0 * (x[1] - x[0] ** 2) * x[0] - 2.0 * (1.0 - x[0])
            g[1] = 200.0 * (x[1] - x[0] ** 2)
            return 0

        def evalSparseCon(self, x, con):
            con[0] = x[0] + x[1] + 5.0

        def addSparseJacobian(self, alpha, x, px, con):
            con[0] += alpha * (px[0] + px[1])

        def addSparseJacobianTranspose(self, alpha, x, pz, out):
            out[0] += alpha * pz[0]
            out[1] += alpha * pz[0]

        def addSparseInnerProduct(self, alpha, x, c, A):
            A[0] += alpha * (c[0] + c[1])

    return SparseRosenbrockCompat()


def dummy(ParOpt, n):
    """A problem that only sizes a quasi-Newton object."""

    class Dummy(ParOpt.Problem):
        def __init__(self):
            super().__init__(None, nvars=n, ncon=0, **_kw(ParOpt))

    return Dummy()


def _tr(ParOpt):
    opt = ParOpt.Optimizer(rosenbrock(ParOpt), {
        "algorithm": "tr", "qn_type": "bfgs",
        "qn_update_type": "damped_update", "tr_init_size": 0.5,
        "tr_min_size": 1e-6, "tr_max_size": 10.0, "tr_eta": 0.1,
        "tr_adaptive_gamma_update": True, "tr_max_iterations": 200,
        "tr_output_file": None, "output_file": None})
    res = opt.optimize()
    x = opt.getOptimizedPoint()[0]
    assert np.allclose(x, [1.0, 1.0], atol=1e-3), x
    return res


def _ip(make, opts):
    def run(ParOpt):
        ip = ParOpt.InteriorPoint(make(ParOpt), dict(opts,
                                                     output_file=None))
        res = ip.optimize()
        assert len(ip.getOptimizedPoint()) == 5
        return res
    return run


def _qn_object(cls_name):
    def run(ParOpt):
        prob = rosenbrock(ParOpt, x0=(-1.0, -1.0))
        ip = ParOpt.InteriorPoint(prob, {"output_file": None,
                                         "abs_res_tol": 1e-7,
                                         "max_major_iters": 300})
        ip.setQuasiNewton(getattr(ParOpt, cls_name)(prob, subspace=8))
        res = ip.optimize()
        assert np.allclose(np.asarray(res["x"]), 1.0, atol=1e-3)
        return res
    return run


SOLVES = {
    "rosenbrock_tr": _tr,
    "interior_point": _ip(rosenbrock, {"abs_res_tol": 1e-7}),
    "csr_sparse": _ip(electron, {"abs_res_tol": 1e-6,
                                 "max_major_iters": 300}),
    "block_callback_sparse": _ip(sparse_rosenbrock,
                                 {"abs_res_tol": 1e-7,
                                  "max_major_iters": 200}),
    "lbfgs_object": _qn_object("LBFGS"),
    "lsr1_object": _qn_object("LSR1"),
}


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_matches_jax(case):
    jr, tr = (SOLVES[case](PKGS[p]) for p in ("jax", "torch"))
    assert tr["converged"] and jr["converged"]
    if case == "lsr1_object":
        np.testing.assert_allclose(np.asarray(tr["x"]), np.asarray(jr["x"]),
                                   rtol=0.0, atol=1e-6)
        return
    assert tr["niter"] == jr["niter"]
    np.testing.assert_allclose(tr["fobj"], jr["fobj"], rtol=1e-10,
                               atol=1e-14)
    np.testing.assert_allclose(np.asarray(tr["x"]), np.asarray(jr["x"]),
                               rtol=0.0, atol=1e-7)


def test_get_options_info_matches_jax():
    """`getOptionsInfo()` (ParOpt.pyx:447-518): the same options, types,
    defaults and ranges as paropt_tpu's, the surface the drivers declare
    their options from."""
    from paropt_torch.utils.options import make_options
    jinfo, tinfo = JParOpt.getOptionsInfo(), TParOpt.getOptionsInfo()
    assert set(tinfo) == set(jinfo) == {d.name for d in
                                        make_options().descriptors()}
    for name, rec in tinfo.items():
        want = jinfo[name]
        assert (rec.option_type, rec.default, rec.values) == (
            want.option_type, want.default, want.values), name
    assert tinfo["algorithm"].default == "tr"
    assert TParOpt.dtype is np.float64


def _accessors(ParOpt, path):
    prob = rosenbrock(ParOpt, x0=(-1.0, 1.0))
    ip = ParOpt.InteriorPoint(prob, {"output_file": None,
                                     "abs_res_tol": 1e-8})
    ip.setMultiplePenaltyGamma([123.0])
    assert float(ip.gamma_t[0]) == 123.0
    res = ip.optimize()
    s, t, sw, tw = ip.getOptimizedSlacks()
    assert s.shape == t.shape == (1,) and sw.shape == tw.shape == (0,)
    ip.writeSolutionFile(path)
    ckpt = ParOpt.unpack_checkpoint(path)
    assert ckpt[0] == float(ip.getBarrierParameter())
    np.testing.assert_array_equal(ckpt[3], np.asarray(res["x"]))
    np.testing.assert_array_equal(ckpt[1], s)
    ip.resetQuasiNewtonHessian()
    assert int(ip._qn_holder["state"].count) == 0
    return res, s, t, ckpt


def test_reference_accessor_surface(tmp_path, capsys):
    """getOptimizedSlacks, setMultiplePenaltyGamma, writeSolutionFile with
    unpack_checkpoint, resetQuasiNewtonHessian, printOptionSummary and the
    MMA accessors (`ParOpt.pyx:318-355, 417-425, 1291-1394`): the same
    values in both packages (1e-10)."""
    jout = _accessors(JParOpt, str(tmp_path / "j.npz"))
    tout = _accessors(TParOpt, str(tmp_path / "t.npz"))
    assert tout[0]["niter"] == jout[0]["niter"]
    for got, want in zip(tout[1:3] + tout[3][1:], jout[1:3] + jout[3][1:]):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
    # the file of either package reads through the other's unpack
    assert TParOpt.unpack_checkpoint(str(tmp_path / "j.npz"))[0] == \
        jout[3][0]

    import jax.numpy as jnp
    from paropt_tpu.models.topology import SyntheticTopology as JTop
    from paropt_torch.models.topology import SyntheticTopology as TTop
    opts = {"mma_max_iterations": 3, "mma_output_file": None,
            "output_file": None}
    hist = {}
    for name, mma in (
            ("jax", JParOpt.MMA(JTop(n=64, block=8, dtype=jnp.float64),
                                dict(opts))),
            ("torch", TParOpt.MMA(TTop(n=64, block=8, dtype=torch.float64,
                                       device="cpu"), dict(opts)))):
        mma.optimize()
        hist[name] = mma.getAsymptotes() + mma.getDesignHistory()
    for got, want in zip(hist["torch"], hist["jax"]):
        assert got.shape == (64,)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    assert np.all(hist["torch"][0] < hist["torch"][1])
    # a subclass, not a patch: the port's MMA class keeps its own surface
    from paropt_torch.mma import MMA
    assert not hasattr(MMA, "getAsymptotes")
    TParOpt.printOptionSummary()
    assert "interior point" in capsys.readouterr().out.lower()


def test_tr_2nd_output_blocks(tmp_path):
    """output_level > 0 writes the ared/pred blocks that
    unpack_tr_2nd_output parses (`ParOptTrustRegion.cpp:1316-1321`): the
    same rows as paropt_tpu's, values within 1e-8 relative."""
    import jax.numpy as jnp
    from paropt_tpu.models.topology import SyntheticTopology as JTop
    from paropt_tpu.tr import TrustRegion as JTR
    from paropt_torch.models.topology import SyntheticTopology as TTop
    out = {}
    for name, prob, cls in (
            ("jax", JTop(n=64, block=8, dtype=jnp.float64), JTR),
            ("torch", TTop(n=64, block=8, dtype=torch.float64,
                           device="cpu"), TParOpt.TrustRegion)):
        path = str(tmp_path / f"{name}.tr")
        cls(prob, {"tr_output_file": path, "output_file": None,
                   "tr_max_iterations": 8, "output_level": 1}).optimize()
        out[name] = TParOpt.unpack_tr_2nd_output(path)
    assert len(out["torch"]["ared(f)"]) >= 1
    for key in ("ared(f)", "pred(f)", "ared(c)", "pred(c)"):
        np.testing.assert_allclose(out["torch"][key], out["jax"][key],
                                   rtol=1e-8, atol=1e-14, err_msg=key)


def test_reset_quasi_newton_hessian_with_eigen_provider():
    """resetQuasiNewtonHessian goes through the provider-aware reset
    (EigenQuasiNewton is not a QNState), as in paropt_tpu."""
    from paropt_torch.eig import CompactEigenApprox, EigenQuasiNewton
    from paropt_torch.models.topology import SyntheticTopology
    from paropt_torch.ops import qn as qnmod
    ip = TParOpt.InteriorPoint(
        SyntheticTopology(n=64, block=8, dtype=torch.float64, device="cpu"),
        {"output_file": None})
    eigh = CompactEigenApprox(nvars=64, N=2, dtype=torch.float64,
                              device="cpu")
    qn0 = qnmod.qn_init(4, 64, dtype=torch.float64, device="cpu")
    s = torch.full((64,), 0.1, dtype=torch.float64)
    qn0, _, _ = qnmod.qn_update(qn0, s, 2.0 * s)
    eqn = EigenQuasiNewton(qn0, eigh, index=0)
    ip.set_quasi_newton_holder({"state": eqn})
    assert int(eqn.qn.count) == 1
    ip.resetQuasiNewtonHessian()
    assert int(eqn.qn.count) == 0


def test_eval_obj_con_shape_error_surfaces():
    """A wrong-shaped constraint return from a callback is a programming
    error and raises, as in paropt_tpu; it is not a failed evaluation."""

    class BadShape(TParOpt.Problem):
        def __init__(self):
            super().__init__(None, nvars=2, ncon=1, device="cpu")

        def getVarsAndBounds(self, x, lb, ub):
            x[:] = 0.0
            lb[:] = -1.0
            ub[:] = 1.0

        def evalObjCon(self, x):
            return 0, 1.0, np.zeros(3)      # ncon = 1 but 3 values

        def evalObjConGradient(self, x, g, A):
            return 0

    ip = TParOpt.InteriorPoint(BadShape(), {"output_file": None})
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        ip.optimize()


def test_lbfgs_direct_drive_matches_jax():
    """The `examples/limited_memory_test` usage mode: LBFGS / LSR1 objects
    driven with update() / mult() / multAdd(), the same products as
    paropt_tpu's (1e-12 relative) and as the dense recursion (1e-8)."""
    rng = np.random.default_rng(12)
    n = 14
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = Q @ np.diag(np.linspace(1.0, 8.0, n)) @ Q.T
    S = rng.standard_normal((n, n))
    Y = A @ S
    xs = rng.standard_normal((4, n))
    for cls_name, kwargs in (("LBFGS", {"update_type": "skip_negative_"
                                                       "curvature"}),
                             ("LSR1", {})):
        got = {}
        for name, ParOpt in PKGS.items():
            qn = getattr(ParOpt, cls_name)(dummy(ParOpt, n), subspace=n,
                                           **kwargs)
            flags = [qn.update(S[:, i], Y[:, i]) for i in range(n)]
            out = np.zeros(n)
            qn.mult(xs[0], out)
            acc = np.ones(n)
            qn.multAdd(0.5, xs[1], acc)
            got[name] = (flags, [qn.mult(x) for x in xs], out, acc)
        assert got["torch"][0] == got["jax"][0]
        for a, b in zip(got["torch"][1:], got["jax"][1:]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12)
        # the dense recursion from B = b0 I with the same pairs
        s0, y0 = S[:, -1], Y[:, -1]
        B = (y0 @ y0 / (s0 @ y0)) * np.eye(n)
        for i in range(n):
            s, y = S[:, i], Y[:, i]
            if cls_name == "LBFGS":
                r = B @ s
                B += -np.outer(r, r) / (s @ r) + np.outer(y, y) / (y @ s)
            else:
                w = y - B @ s
                B += np.outer(w, w) / (w @ s)
        for x, prod in zip(xs, got["torch"][1]):
            assert np.linalg.norm(prod - B @ x) < 1e-8 * np.linalg.norm(
                B @ x)
        np.testing.assert_allclose(got["torch"][3], 1.0 + 0.5 *
                                   got["torch"][1][1], rtol=1e-14)


def test_callback_reads_are_counted_and_read_only():
    """Each callback reads x through the problem's ``syncs``, which the
    host IP shares, as a read-only float64 array; a CSR problem keeps its
    values on the host."""
    seen = []

    class Probe(type(rosenbrock(TParOpt))):
        def evalObjCon(self, x):
            seen.append((x.dtype.name, x.flags.writeable))
            return super().evalObjCon(x)

    prob = Probe()
    ip = TParOpt.InteriorPoint(prob, {"output_file": None,
                                      "abs_res_tol": 1e-7})
    assert ip.syncs is prob.syncs
    res = ip.optimize()
    assert seen and set(seen) == {("float64", False)}
    assert prob.syncs.count > res["niter"] + len(seen)
    sparse = electron(TParOpt)
    assert sparse.use_csr_path and sparse.nwcon == 6
    assert not sparse_rosenbrock(TParOpt).use_csr_path
