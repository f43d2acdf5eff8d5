"""The general-CSR and callback-sparse paths of the host interior point:
paropt_torch against paropt_tpu in float64 on the CPU.

- `CSRSparseProblem.colored_jacobian_fill` against JAX's on the 12-node
  brachistochrone and SSTO transcriptions, entry for entry;
- the host `InteriorPoint` on `ElectronCSR(10)`, on
  `BrachistochroneCollocation(12)` and `SSTOCollocation(10)` with the
  dymos options, and on the callback-only `SparseRosenbrock`, with
  `ElectronCSR` also under the Mehrotra predictor-corrector: the same
  iteration and evaluation counts, fobj to 1e-10 relative, x to 1e-8, logs
  that parse alike and the same 'MatInfo' rows;
- a `sparse_jacobian` that raises anything but NotImplementedError
  propagates; the CSR branch of `check_gradients`;
- one iteration of each package from a JAX CSR solve stopped midway
  (`convert.load_interior_point`);
- the facade's 'tr' and 'mma' routes on `ElectronCSR`, which JAX takes
  through the padded Jacobian's block path;
- a float32 CSR solve keeps its dtype (the JAX package turns float64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paropt_tpu import ip as jip
from paropt_tpu.models import analytic as ja
from paropt_tpu.models import brachistochrone as jb
from paropt_tpu.models import cops as jc
from paropt_tpu.models import ssto as js
from paropt_torch import convert
from paropt_torch import ip as tip
from paropt_torch.models import analytic as ta
from paropt_torch.models import (BrachistochroneCollocation, ElectronCSR,
                                 SSTOCollocation)
from paropt_torch.ops import kkt

from ._torch_parity import (assert_close, assert_facade_matches,
                            assert_same_ip_solve, ip_side_by_side,
                            jax_ip_state)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")

# the option set of the reference's dymos examples
# (tests/test_brachistochrone.py, examples/ssto.py)
DYMOS = {"norm_type": "infinity", "qn_subspace_size": 10,
         "starting_point_strategy": "least_squares_multipliers",
         "qn_update_type": "damped_update", "abs_res_tol": 1e-6,
         "barrier_strategy": "monotone", "armijo_constant": 1e-5,
         "penalty_gamma": 100.0, "max_major_iters": 500}


class _JCallbackOnly(ja.SparseRosenbrock):
    """No structured Jacobian: the products fall back to jvp / vjp of the
    sparse constraints, the block inner product is the problem's own."""

    def sparse_jacobian(self, x):
        raise NotImplementedError

    def sparse_inner_product(self, x, cvec):
        Aw = jax.jacrev(self.sparse_constraints)(x)
        return ((Aw * cvec) @ Aw.T).reshape(-1, 1, 1)


class _TCallbackOnly(ta.SparseRosenbrock):
    def sparse_jacobian(self, x):
        raise NotImplementedError

    def sparse_inner_product(self, x, cvec):
        Aw = torch.func.jacrev(self.sparse_constraints)(x)
        return ((Aw * cvec) @ Aw.T).reshape(-1, 1, 1)


def _matinfo(path):
    return [ln for ln in open(path) if ln.startswith("MatInfo:")]


@pytest.mark.parametrize("model", ["brachistochrone", "ssto"])
def test_colored_fill_matches_jax_entry_for_entry(model):
    jcls, tcls = {"brachistochrone": (jb.BrachistochroneCollocation,
                                      BrachistochroneCollocation),
                  "ssto": (js.SSTOCollocation, SSTOCollocation)}[model]
    jp, tp = jcls(12), tcls(12, **F64)
    np.testing.assert_array_equal(tp.csr_rowp, jp.csr_rowp)
    np.testing.assert_array_equal(tp.csr_cols, jp.csr_cols)
    rng = np.random.default_rng(0)
    x = np.asarray(jp.get_vars_and_bounds()[0]) + 0.1 * rng.standard_normal(
        jp.nvars)
    want = np.asarray(jp.eval_sparse_jacobian_data(jnp.asarray(x)))
    got = tp.eval_sparse_jacobian_data(torch.as_tensor(x))
    assert got.shape == want.shape == (int(jp.csr_rowp[-1]),)
    # the tangent arithmetic rounds differently: a few ulps of the largest
    assert_close(got, want, rtol=0.0, atol=4e-16 * np.abs(want).max())
    # the fill agrees with the dense Jacobian at the pattern's entries
    dense = torch.func.jacfwd(tp.sparse_constraints)(torch.as_tensor(x))
    rows = np.repeat(np.arange(tp.nwcon), np.diff(tp.csr_rowp))
    assert_close(got, dense[rows, tp.csr_cols], rtol=0.0,
                 atol=4e-16 * np.abs(want).max())
    # the padded structured Jacobian carries the same values
    aw = tp.sparse_jacobian(torch.as_tensor(x))
    px = rng.standard_normal(tp.nvars)
    assert_close(aw.matvec(torch.as_tensor(px)), dense @ torch.as_tensor(px),
                 rtol=1e-13, atol=1e-13)


CASES = {
    "electron_csr": (lambda: jc.ElectronCSR(10),
                     lambda: ElectronCSR(10, **F64), {"abs_res_tol": 1e-6}),
    # the eager paths take the plain step at the adapted μ (JAX's quirk)
    "electron_csr_mpc": (lambda: jc.ElectronCSR(10),
                         lambda: ElectronCSR(10, **F64),
                         {"abs_res_tol": 1e-6, "barrier_strategy":
                          "mehrotra_predictor_corrector"}),
    "brachistochrone": (lambda: jb.BrachistochroneCollocation(12),
                        lambda: BrachistochroneCollocation(12, **F64),
                        DYMOS),
    "ssto": (lambda: js.SSTOCollocation(10),
             lambda: SSTOCollocation(10, **F64), DYMOS),
    "callback_rosenbrock": (_JCallbackOnly,
                            lambda: _TCallbackOnly(**F64),
                            {"abs_res_tol": 1e-7}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_ip_matches_jax(name, tmp_path):
    jmake, tmake, opts = CASES[name]
    jr, tr, js_, ts = ip_side_by_side(jmake(), tmake(), opts, tmp_path)
    assert jr["converged"]
    assert_same_ip_solve(jr, tr, tmp_path)
    assert _matinfo(tmp_path / "t") == _matinfo(tmp_path / "j")
    assert ts._eager and js_._eager
    if name == "callback_rosenbrock":
        assert ts._callback_sparse and ts._csr_mat is None
    else:
        assert not ts._callback_sparse
        assert _matinfo(tmp_path / "t")[0].startswith("MatInfo: CSR")
        mat = ts._csr_mat.mat
        assert mat.nfactor > tr["niter"]
        if "barrier_strategy" not in opts or opts["barrier_strategy"] == \
                "monotone":
            assert mat.nfactor == js_._csr_mat.nfactor
        else:
            # JAX also factors for a step at the old μ before the affine
            # probe, and discards it: one factorization more per iteration
            assert js_._csr_mat.nfactor - mat.nfactor == tr["niter"]
        # every factor reads Dinv and C0, every solve its right-hand sides
        assert ts.syncs.count > 2 * mat.nfactor


def test_buggy_sparse_jacobian_raises():
    """Only NotImplementedError demotes a problem to the callback path;
    any other error of the user's Jacobian propagates, as in JAX."""
    class Buggy(ta.SparseRosenbrock):
        def sparse_jacobian(self, x):
            raise ValueError("bug in user Jacobian")

    with pytest.raises(ValueError, match="bug in user Jacobian"):
        tip.InteriorPoint(Buggy(**F64), {"output_file": None})


def test_check_gradients_on_a_csr_problem():
    """The CSR branch has no block inner-product check; the rest agrees
    with JAX's."""
    jp, tp = jb.BrachistochroneCollocation(12), BrachistochroneCollocation(
        12, **F64)
    want = jp.check_gradients(1e-6, verbose=False)
    got = tp.check_gradients(1e-6, verbose=False)
    assert sorted(got) == sorted(want)
    assert "sparse_inner_product" not in got
    assert got["obj_gradient"] < 1e-8 and got["sparse_jacobian"] < 1e-6
    assert got["sparse_adjoint"] < 1e-12


def test_one_iteration_from_a_jax_csr_state():
    """Six iterations of JAX's ElectronCSR solve, then one more of each
    package from that state: every IPVars field, the QN state, μ and ρ to
    1e-12."""
    opts = {"output_file": None, "max_major_iters": 6}
    js_ = jip.InteriorPoint(jc.ElectronCSR(10), opts)
    js_.optimize()
    state = jax_ip_state(js_)
    one = dict(opts, max_major_iters=1,
               starting_point_strategy="no_start_strategy")
    jn = jip.InteriorPoint(jc.ElectronCSR(10), one)
    jn.vars = dataclasses.replace(js_.vars)
    jn.qn, jn.mu, jn.rho_penalty = js_.qn, js_.mu, js_.rho_penalty
    tn = convert.load_interior_point(
        tip.InteriorPoint(ElectronCSR(10, **F64), one), state)
    jn.optimize()
    tn.optimize()
    for f in dataclasses.fields(jn.vars):
        assert_close(getattr(tn.vars, f.name), getattr(jn.vars, f.name),
                     rtol=1e-12, atol=1e-14, name=f.name)
    for name in ("buf", "SS", "SY", "b0"):
        assert_close(getattr(tn.qn, name), getattr(jn.qn, name), rtol=1e-12,
                     atol=1e-14, name=name)
    assert (tn.mu, tn.rho_penalty) == pytest.approx((jn.mu, jn.rho_penalty),
                                                    rel=1e-12)
    assert tn._csr_mat.mat.nfactor == jn._csr_mat.nfactor


@pytest.mark.parametrize("algorithm", ["tr", "mma"])
def test_facade_on_a_csr_problem(algorithm):
    """paropt_tpu's facade runs the host TrustRegion / MMA on a CSR
    problem; their subproblems take the padded Jacobian's block path (for
    ElectronCSR the 'blocked_t' layout).  The port does the same."""
    cap = {"tr": {"tr_max_iterations": 6},
           "mma": {"mma_max_iterations": 6}}[algorithm]
    assert_facade_matches(jc.ElectronCSR(10), ElectronCSR(10, **F64),
                          dict(cap, algorithm=algorithm), algorithm)


def test_float32_csr_solve_keeps_its_dtype():
    """The host factor works in float64; the port returns the solve to the
    solve's dtype (JAX keeps float64, and its state turns float64 after
    the first step: ROADMAP queue 3)."""
    seen = []

    class Spy(kkt.HostCSRFactor):
        def solve(self, rw):
            out = super().solve(rw)
            seen.append((rw.dtype, out.dtype))
            return out

    prob = ElectronCSR(10, dtype=torch.float32, device="cpu")
    ip = tip.InteriorPoint(prob, {"output_file": None, "dtype": "float32",
                                  "max_major_iters": 3})
    ip._csr_mat = Spy(ip._csr_mat.mat, ip.syncs)
    res = ip.optimize()
    assert seen and all(a == b == torch.float32 for a, b in seen)
    assert res["x"].dtype == torch.float32 and np.isfinite(res["fobj"])
