"""Each CUDA kernel of paropt_torch against its plain PyTorch version, on a
card; every test here is marked ``cuda`` and skips without one (the `cuda`
fixture decides, at run time).  The file imports no jax, so on a machine
with a card and no jax it runs without the JAX conftest:

    python -m pytest tests/test_torch_kernels_cuda.py -q -p no:cacheprovider --noconftest

Tolerances: f64 1e-12 relative (exposes indexing faults); f32 and bf16
storage (f32 accumulation) 1e-5, the reordering of the sums."""

import dataclasses

import pytest
import torch

from paropt_torch import Optimizer
from paropt_torch.models.topology import SyntheticTopology
from paropt_torch.ops import kernels
from paropt_torch.tr import FusedTR

from ._torch_parity import assert_close, cuda, qd_inputs  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_qn_roll_matches_plain(cuda, dtype):
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(0)
    buf = torch.randn(20, 5000, device=cuda, dtype=cdt, generator=gen)
    buf = buf.to(dtype)
    s = torch.randn(5000, device=cuda, dtype=cdt, generator=gen)
    y = torch.randn(5000, device=cuda, dtype=cdt, generator=gen)
    for flag in (True, False):
        upd = torch.tensor(flag, device=cuda)
        before = kernels.LAUNCHES["qn_roll_update"]
        ko, kd = kernels.qn_roll_update(buf, s, y, upd)
        assert kernels.LAUNCHES["qn_roll_update"] == before + 1
        po, pd = kernels.qn_roll_update_plain(buf, s, y, upd)
        assert torch.equal(ko, po)
        # f64: indexing-exact; f32 accumulation: summation order only
        rtol = 1e-12 if dtype == torch.float64 else 1e-5
        assert_close(kd, pd, rtol=rtol, atol=rtol * float(pd.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_quasi_def_matches_plain(cuda, dtype):
    for K, nwcon in ((1, 4096), (21, 1000)):
        args = [torch.as_tensor(a, dtype=dtype, device=cuda)
                for a in qd_inputs(K, 8, nwcon, seed=3)]
        rtol = 1e-12 if dtype == torch.float64 else 1e-5
        for got, want in zip(kernels.quasi_def_apply(*args),
                             kernels.quasi_def_apply_plain(*args)):
            assert_close(got, want, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_phi_gram_matches_plain(cuda, dtype):
    for B, nwcon in ((21, 4096), (21, 1000)):
        args = [torch.as_tensor(a, dtype=dtype, device=cuda)
                for a in qd_inputs(B, 8, nwcon, seed=4)]
        rtol = 1e-12 if dtype == torch.float64 else 1e-5
        for got, want in zip(kernels.phi_gram(*args),
                             kernels.phi_gram_plain(*args)):
            assert_close(got, want, rtol=rtol,
                         atol=rtol * float(want.abs().max()))


# the rebuilt kernels over stack heights, row counts (k <= 8 keeps a
# column's rows in registers, k = 13 loops) and column counts: 4096 and
# 1000 take the 16-byte paths (1000 with a ragged last tile in phi_gram),
# 1001 the scalar ones
SHAPES = [(B, k, nwcon) for B in (1, 7, 21, 22) for k in (1, 8, 13)
          for nwcon in (4096, 1000, 1001)]
DTYPES = [torch.float32, torch.float64]


def _rtol(dtype):
    return 1e-12 if dtype == torch.float64 else 1e-5


def _held_to_plain(got, want, dtype):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w, rtol=_rtol(dtype),
                     atol=_rtol(dtype) * float(w.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,k,nwcon", SHAPES)
def test_cuda_quasi_def_shapes_repeat_bitwise(cuda, B, k, nwcon, dtype):
    args = [torch.as_tensor(a, dtype=dtype, device=cuda)
            for a in qd_inputs(B, k, nwcon, seed=B + k + nwcon)]
    got = kernels.quasi_def_apply(*args)
    _held_to_plain(got, kernels.quasi_def_apply_plain(*args), dtype)
    again = kernels.quasi_def_apply(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,k,nwcon", SHAPES)
def test_cuda_phi_gram_shapes_repeat_bitwise(cuda, B, k, nwcon, dtype):
    """The stack read whole with bw, and as two row blocks with bw = 0 (the
    factor setup's call); two calls on the same inputs agree bit for bit."""
    dinv, cwinv, vals, bx, bw = (
        torch.as_tensor(a, dtype=dtype, device=cuda)
        for a in qd_inputs(B, k, nwcon, seed=B * k + nwcon))
    before = kernels.LAUNCHES["phi_gram"]
    got = kernels.phi_gram(dinv, cwinv, vals, bx, bw)
    assert kernels.LAUNCHES["phi_gram"] == before + 1
    _held_to_plain(got, kernels.phi_gram_plain(dinv, cwinv, vals, bx, bw),
                   dtype)
    again = kernels.phi_gram(dinv, cwinv, vals, bx, bw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    top = max(1, B - 1)
    tail = bx[top:] if top < B else None
    split = kernels.phi_gram(dinv, cwinv, vals, bx[:top], None, tail)
    _held_to_plain(split, kernels.phi_gram_plain(dinv, cwinv, vals, bx),
                   dtype)


def test_cuda_fused_tr_launches_every_kernel_and_matches_host(cuda):
    """FusedTR on SyntheticTopology(4096) in float64: on the card the
    steering and QP solves launch the quasi-definite apply, every QP factor
    setup phi_gram and every outer QN update qn_roll_update; the card run
    takes the host run's outer and inner iterations, fobj to 1e-9."""
    opts = {"tr_output_file": None, "output_file": None,
            "tr_max_iterations": 6, "abs_res_tol": 1e-8}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        prob = SyntheticTopology(n=4096, block=8, dtype=torch.float64,
                                 device=dev)
        kernels.reset_launches()
        res, _ = FusedTR(prob, dict(opts)).solve()
        out[dev.type] = (res, dict(kernels.LAUNCHES))
    (rc, lc), (rh, lh) = out["cuda"], out["cpu"]
    assert lc["qn_roll_update"] == rc["niter"]
    assert lc["quasi_def_apply"] > 0 and lc["phi_gram"] > 0
    assert not any(lh.values())
    assert (rc["niter"], rc["subiters"]) == (rh["niter"], rh["subiters"])
    assert abs(rc["fobj"] - rh["fobj"]) <= 1e-9 * abs(rh["fobj"])


def _tensors(obj, seen=None):
    """Every tensor reachable from a solver object's attributes (tensors,
    dataclass states, dicts, lists and tuples, nested solver objects)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name), seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, seen)
    elif type(obj).__module__.startswith("paropt_torch"):
        for v in vars(obj).values():
            yield from _tensors(v, seen)


@pytest.mark.parametrize("algorithm", ["ip", "tr", "mma"])
def test_cuda_host_routes_keep_state_on_the_card(cuda, algorithm):
    """The facade's host loops on SyntheticTopology(4096) in float64 on the
    card: every tensor the solver holds is a CUDA tensor, and the kernels
    launch (all three on the IP and TR paths; the quasi-definite apply in
    the MMA's inner solves on this blocked_t problem)."""
    prob = SyntheticTopology(n=4096, block=8, dtype=torch.float64,
                             device=cuda)
    opt = Optimizer(prob, {"algorithm": algorithm, "output_file": None,
                           "tr_output_file": None, "mma_output_file": None,
                           "max_major_iters": 30, "tr_max_iterations": 3,
                           "mma_max_iterations": 3})
    kernels.reset_launches()
    res = opt.optimize()
    assert res["x"].is_cuda and torch.isfinite(res["x"]).all()
    held = list(_tensors(opt._inner))
    assert held and all(t.is_cuda for t in held), \
        [t.device for t in held if not t.is_cuda]
    if algorithm == "mma":
        assert kernels.LAUNCHES["quasi_def_apply"] > 0
    else:
        assert all(n > 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


NK_OPTS = {"use_hvec_product": True, "gmres_subspace_size": 25,
           "eisenstat_walker_gamma": 0.05, "nk_switch_tol": 1e-3}


def test_cuda_nk_solve_matches_the_cpu(cuda):
    """The host IP with the Newton-Krylov phase on SyntheticTopology(2^14)
    in float64: on the card its GMRES preconditioner launches the
    quasi-definite apply and each NK factor setup phi_gram; the card run
    takes the CPU run's iterations and Hessian-vector products, fobj to
    1e-9."""
    out = {}
    for dev in (cuda, torch.device("cpu")):
        prob = SyntheticTopology(n=1 << 14, block=8, dtype=torch.float64,
                                 device=dev)
        opt = Optimizer(prob, dict(NK_OPTS, algorithm="ip",
                                   output_file=None, abs_res_tol=1e-6,
                                   max_major_iters=60))
        kernels.reset_launches()
        res = opt.optimize()
        out[dev.type] = (res, opt._inner.nhvec, dict(kernels.LAUNCHES))
    (rc, hc, lc), (rh, hh, lh) = out["cuda"], out["cpu"]
    assert rc["converged"] and rh["converged"]
    assert hc == hh > 0
    assert rc["niter"] == rh["niter"]
    assert all(n > 0 for n in lc.values()), lc
    assert not any(lh.values())
    assert abs(rc["fobj"] - rh["fobj"]) <= 1e-9 * abs(rh["fobj"])
