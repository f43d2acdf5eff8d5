"""Shared helpers for the paropt_torch parity tests.

The same inputs, made with numpy from a seed, go through a paropt_tpu
function and its paropt_torch counterpart; these helpers move states
between the two as numpy arrays and build the small random KKT cases."""

import dataclasses

import numpy as np
import pytest
import torch


def np_of(x):
    """numpy array of a torch tensor or JAX array (bfloat16 -> float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def fields_of(obj):
    """A JAX dataclass state as the dict `paropt_torch.convert` takes:
    numpy arrays for the leaves, plain values for the static fields, nested
    dicts for nested states and NamedTuples."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = fields_of(v)
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            # a NamedTuple leaf group (e.g. FusedEigTRState.eig)
            out[f.name] = {k: np.asarray(a) for k, a in v._asdict().items()}
        elif f.metadata.get("static") or v is None:
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def jax_ip_state(s):
    """A JAX InteriorPoint's state as the dict
    `paropt_torch.convert.load_interior_point` takes."""
    return {"vars": fields_of(s.vars),
            "qn": None if s.qn is None else fields_of(s.qn),
            "mu": s.mu, "rho_penalty": s.rho_penalty,
            **{k: np.asarray(getattr(s, k)) for k in ("fobj", "c", "cw", "g",
                                                       "A")},
            **{k: getattr(s, k) for k in ("niter", "neval", "ngeval",
                                          "nhvec")}}


def assert_close(got, want, rtol, atol=0.0, name=""):
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=rtol, atol=atol,
                               err_msg=name)


def assert_rel(got, want, rtol, name=""):
    """max |got - want| <= rtol * max |want|: a tolerance relative to the
    reference's largest entry, for outputs whose entries cancel to ~0 and
    carry the roundoff of the terms that cancelled."""
    got, want = np_of(got), np_of(want)
    assert got.shape == want.shape, name
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol:.0e} * {scale:.3e}"


def assert_fields_close(got, want, rtol, atol=0.0, names=None):
    """Field-for-field comparison of a port dataclass with a JAX one."""
    for f in dataclasses.fields(want):
        if names is not None and f.name not in names:
            continue
        b = getattr(want, f.name)
        if f.metadata.get("static") or b is None:
            continue
        a = getattr(got, f.name)
        if dataclasses.is_dataclass(b):
            assert_fields_close(a, b, rtol, atol)
        elif isinstance(b, tuple) and hasattr(b, "_fields"):
            for name, ai, bi in zip(b._fields, a, b):
                assert_close(ai, bi, rtol, atol, name=f"{f.name}.{name}")
        else:
            assert_close(a, b, rtol, atol, name=f.name)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: a CUDA kernel has no interpret mode, so
    its check against the plain version runs only on a card (chip_smoke.py
    runs the same checks at the main path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# random KKT cases (numpy), one per sparse-Jacobian layout
# ---------------------------------------------------------------------------


def kkt_case(layout, nwblock=1, ncon=1, k=4, nwcon=64, seed=0):
    """numpy fields of a ProblemData and an IPVars strictly inside the
    bounds, with the sparse pattern of ``layout``."""
    rng = np.random.default_rng(seed)
    if layout == "blocked_t":
        n = k * nwcon
        cols = (np.arange(nwcon)[:, None] + np.arange(k)[None, :] * nwcon)
    elif layout == "blocked":
        n = k * nwcon
        cols = np.arange(n).reshape(nwcon, k)
    else:
        # general gather pattern; with nwblock > 1 the rows of one block
        # share their columns, so the Cw blocks have off-diagonal entries
        nblocks = nwcon // nwblock
        n = nblocks * k
        perm = rng.permutation(n).reshape(nblocks, k)
        cols = np.repeat(perm, nwblock, axis=0)
    cols = cols.astype(np.int32)
    pos = lambda *shape: rng.uniform(0.4, 1.6, shape)
    d = dict(
        g=rng.standard_normal(n), A=rng.standard_normal((ncon, n)),
        c=rng.standard_normal(ncon), cw=rng.standard_normal(nwcon),
        lb=np.full(n, -1.0), ub=np.full(n, 1.0),
        lb_mask=np.ones(n), ub_mask=np.ones(n),
        gamma_s=np.zeros(ncon), gamma_t=np.full(ncon, 1e3),
        gamma_sw=np.zeros(nwcon), gamma_tw=np.full(nwcon, 1e3),
        Aw_cols=cols, Aw_vals=rng.standard_normal((nwcon, k)),
        nwblock=nwblock, Aw_layout=layout)
    v = dict(x=rng.uniform(-0.5, 0.5, n), zl=pos(n), zu=pos(n),
             s=pos(ncon), t=pos(ncon), z=rng.standard_normal(ncon),
             zs=pos(ncon), zt=pos(ncon), sw=pos(nwcon), tw=pos(nwcon),
             zw=rng.standard_normal(nwcon), zsw=pos(nwcon), ztw=pos(nwcon))
    return d, v


def qd_inputs(K, k, nwcon, seed):
    """numpy operands of the quasi-definite apply: dinv, cwinv, vals_t
    ([k, nwcon]), bx [K, k, nwcon], bw [K, nwcon], with a well-conditioned
    Cw = C0 + Σ vals² dinv."""
    rng = np.random.default_rng(seed)
    dinv = rng.uniform(0.5, 2.0, (k, nwcon))
    vals = rng.standard_normal((k, nwcon))
    cwinv = 1.0 / (rng.uniform(0.5, 1.5, nwcon) + np.sum(vals ** 2 * dinv, 0))
    return (dinv, cwinv, vals, rng.standard_normal((K, k, nwcon)),
            rng.standard_normal((K, nwcon)))


def qn_pairs(n, count, seed=0):
    """(s, y) pairs with positive curvature for a QN history."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(count):
        s = rng.standard_normal(n)
        pairs.append((s, 2.0 * s + 0.3 * rng.standard_normal(n)))
    return pairs


# ---------------------------------------------------------------------------
# the optimizers' fixed-width logs
# ---------------------------------------------------------------------------

# parser name, integer columns, the relative precision each float column is
# printed with (one unit of its last digit), the number of parsed columns
# before the info flags
LOG_SPECS = {
    "ip": ("unpack_output", ("iter", "nobj", "ngrd", "nhvc"),
           dict(dict.fromkeys(("alpha", "alphx", "alphz", "opt", "infes",
                               "dual", "mu", "comp", "dmerit", "rho"), 0.1),
                fobj=1e-5), 15),
    "tr": ("unpack_tr_output", ("iter",),
           dict(dict.fromkeys(("infeas", "l1", "linfty", "xnorm", "tr", "rho",
                               "smodel", "avgz", "maxz", "avgpen",
                               "maxpen"), 0.01), fobj=1e-5), 14),
    "mma": ("unpack_mma_output", ("iter", "subiter"),
            dict(dict.fromkeys(("l1", "linfty", "l1lambda", "infeas"), 1e-3),
                 fobj=1e-6), 7),
}


def log_info_flags(path, ncols):
    """The info text after the parsed columns of each iteration row."""
    out = []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) >= ncols and parts[0].lstrip("-").isdigit():
                out.append(" ".join(parts[ncols:]))
    return out


def assert_logs_alike(jpath, tpath, kind):
    """A log written by paropt_tpu and one written by paropt_torch parse
    alike with both packages' parsers: the same columns and rows, equal
    integer columns and info flags, each float column within one unit of
    its printed precision (the wall-time column of the TR log aside)."""
    from paropt_tpu.utils import logging as jlog
    from paropt_torch.utils import logging as tlog
    name, ints, rtols, ncols = LOG_SPECS[kind]
    for mod in (jlog, tlog):
        j, t = getattr(mod, name)(str(jpath)), getattr(mod, name)(str(tpath))
        assert list(j) == list(t)
        assert len(j["iter"]) == len(t["iter"]) > 0
        for col in ints:
            np.testing.assert_array_equal(t[col], j[col], err_msg=col)
        for col, rtol in rtols.items():
            scale = float(np.nanmax(np.abs(j[col]), initial=0.0))
            np.testing.assert_allclose(t[col], j[col], rtol=rtol,
                                       atol=1e-9 * scale, equal_nan=True,
                                       err_msg=col)
    assert log_info_flags(tpath, ncols) == log_info_flags(jpath, ncols)


def ip_side_by_side(jprob, tprob, opts, tmp_path, setup=None):
    """Both packages' host InteriorPoint on the same problem and options,
    writing their logs to ``tmp_path / "j"`` and ``tmp_path / "t"``;
    returns (jax result, torch result, jax solver, torch solver).
    ``setup(solver, package)`` adjusts a solver before the solve."""
    from paropt_tpu import ip as jip
    from paropt_torch import ip as tip
    js = jip.InteriorPoint(jprob, dict(opts, output_file=str(tmp_path / "j")))
    ts = tip.InteriorPoint(tprob, dict(opts, output_file=str(tmp_path / "t")))
    if setup is not None:
        setup(js, "jax")
        setup(ts, "torch")
    return js.optimize(), ts.optimize(), js, ts


def assert_same_ip_solve(jr, tr, tmp_path, x_tol=1e-8):
    """The same iteration and evaluation counts, reason and outcome, fobj
    to 1e-10 relative, x to ``x_tol`` and logs that parse alike."""
    assert (tr["niter"], tr["neval"], tr["ngeval"], tr["reason"],
            tr["converged"]) == (jr["niter"], jr["neval"], jr["ngeval"],
                                 jr["reason"], jr["converged"])
    # absolute 1e-14 for the solves that end at fobj = 0 (roundoff there)
    assert tr["fobj"] == pytest.approx(jr["fobj"], rel=1e-10, abs=1e-14)
    assert_close(tr["x"], jr["x"], rtol=0.0, atol=x_tol, name="x")
    assert_logs_alike(tmp_path / "j", tmp_path / "t", "ip")


def tr_side_by_side(jprob, tprob, opts, tmp_path, jsub=None, tsub=None):
    """Both packages' host TrustRegion on the same problem and options
    (``jsub``/``tsub``: custom subproblems), writing their logs to
    ``tmp_path / "j"`` and ``tmp_path / "t"``; returns (jax result, torch
    result, jax solver, torch solver)."""
    from paropt_tpu import tr as jtr
    from paropt_torch import tr as ttr
    js = jtr.TrustRegion(jprob, dict(opts, tr_output_file=str(tmp_path / "j")),
                         subproblem=jsub)
    ts = ttr.TrustRegion(tprob, dict(opts, tr_output_file=str(tmp_path / "t")),
                         subproblem=tsub)
    return js.optimize(), ts.optimize(), js, ts


def assert_same_tr_solve(jr, tr, tmp_path):
    """The same outer iterations and outcome, fobj to 1e-10 relative, x to
    1e-8, the KKT measures to 1e-6 and logs that parse alike."""
    assert (tr["niter"], tr["converged"]) == (jr["niter"], jr["converged"])
    assert tr["fobj"] == pytest.approx(jr["fobj"], rel=1e-10)
    assert_close(tr["x"], jr["x"], rtol=0.0, atol=1e-8, name="x")
    for key in ("infeas", "l1", "linfty"):
        assert tr[key] == pytest.approx(jr[key], rel=1e-6, abs=1e-12), key
    assert_logs_alike(tmp_path / "j", tmp_path / "t", "tr")


def assert_facade_matches(jprob, tprob, opts, algorithm, log_dir=None):
    """`Optimizer(problem, opts)` of both packages: the same host solver
    class, iterations, fobj to 1e-10 relative and `get_optimized_point` to
    1e-8 (for 'tr', the multipliers of the host IP over the quadratic
    subproblem, which the fused inner solves leave at their start, in JAX
    as in the port).  ``opts`` leaves ``use_fused_loop`` unset.  With
    ``log_dir`` each package writes its solver's log there, and x and the
    logs are held alike too."""
    from paropt_tpu.optimizer import Optimizer as JOptimizer
    from paropt_torch import Optimizer
    opts = dict(opts, output_file=None, tr_output_file=None,
                mma_output_file=None)
    jopts, topts = dict(opts), dict(opts)
    if log_dir is not None:
        key = {"ip": "output_file", "tr": "tr_output_file",
               "mma": "mma_output_file"}[algorithm]
        jopts[key], topts[key] = str(log_dir / "j"), str(log_dir / "t")
    jopt = JOptimizer(jprob, jopts)
    jres = jopt.optimize()
    opt = Optimizer(tprob, topts)
    assert opt.algorithm == algorithm
    with pytest.raises(RuntimeError):
        opt.get_optimized_point()
    res = opt.optimize()
    assert type(opt._inner).__name__ == type(jopt._inner).__name__
    assert res["niter"] == jres["niter"]
    assert res["fobj"] == pytest.approx(jres["fobj"], rel=1e-10)
    for got, want in zip(opt.get_optimized_point(),
                         jopt.get_optimized_point()):
        assert_close(got, want, rtol=0.0, atol=1e-8)
    if log_dir is not None:
        assert_close(res["x"], jres["x"], rtol=0.0, atol=1e-8, name="x")
        assert_logs_alike(log_dir / "j", log_dir / "t", algorithm)
    return jopt, opt
