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


def test_cuda_fused_eigen_tr_matches_host(cuda):
    """FusedEigenTR on FrequencyTopology(8, 4, N=3, mgcg) in float64 with
    bench.py's eigen-TR options, 4 outer iterations: the card run takes the
    host run's outer and inner iterations and LOBPCG block counts, fobj to
    1e-9.  Its only kernel is the outer QN update's qn_roll_update, once
    per outer iteration: the frequency problem has no sparse constraints
    (nwcon = 0), so no inner solve reaches the quasi-definite kernels."""
    from paropt_torch.models.fem_frequency import FrequencyTopology
    opts = {"tr_output_file": None, "output_file": None,
            "tr_max_iterations": 4, "tr_init_size": 0.05,
            "tr_max_size": 0.2, "tr_min_size": 1e-6, "abs_res_tol": 1e-8,
            "tr_l1_tol": 1e-4, "tr_linfty_tol": 1e-4,
            "tr_adaptive_gamma_update": True, "penalty_gamma": 10.0,
            "dtype": "float64"}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        prob = FrequencyTopology(8, 4, N=3, cg_iters=25, solver="mgcg",
                                 lobpcg_iters=50, dtype=torch.float64,
                                 device=dev)
        kernels.reset_launches()
        res, _ = prob.build_fused_tr(dict(opts)).solve()
        out[dev.type] = (res, list(prob.lobpcg_iters_log),
                         dict(kernels.LAUNCHES))
    (rc, bc, lc), (rh, bh, lh) = out["cuda"], out["cpu"]
    assert lc == {"qn_roll_update": rc["niter"], "quasi_def_apply": 0,
                  "phi_gram": 0}, lc
    assert not any(lh.values())
    assert (rc["niter"], rc["subiters"]) == (rh["niter"], rh["subiters"])
    assert bc == bh
    assert abs(rc["fobj"] - rh["fobj"]) <= 1e-9 * abs(rh["fobj"])


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


# ---------------------------------------------------------------------------
# the instance axis (k solves run as one, `solve_batched`)
# ---------------------------------------------------------------------------

KB = 4


def _stack_inputs(B, k, nwcon, dtype, device, shared_vals, kb=KB):
    """kb instances of the quasi-definite operands; with ``shared_vals``
    vals_t is one [k, nwcon] array expanded over the instances (stride 0),
    as a batched solve passes it."""
    per = [qd_inputs(B, k, nwcon, seed=17 * i + B) for i in range(kb)]
    ops = [torch.stack([torch.as_tensor(p[j], dtype=dtype, device=device)
                        for p in per]) for j in range(5)]
    if shared_vals:
        ops[2] = ops[2][0].expand(kb, k, nwcon)
    return ops


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_cuda_qn_roll_instance_axis(cuda, dtype):
    """One launch over kb = 4 instances: against the plain version batched,
    bit-equal to 4 single launches, at kb = 1 bit-equal to the single
    launch, and with a buffer shared by the instances (stride 0)."""
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(1)
    buf = torch.randn(KB, 20, 5000, device=cuda, dtype=cdt,
                      generator=gen).to(dtype)
    s = torch.randn(KB, 5000, device=cuda, dtype=cdt, generator=gen)
    y = torch.randn(KB, 5000, device=cuda, dtype=cdt, generator=gen)
    upd = torch.tensor([True, False, True, True], device=cuda)
    before = dict(kernels.BATCHED_LAUNCHES)
    got = kernels.qn_roll_update_batched(buf, s, y, upd)
    assert kernels.BATCHED_LAUNCHES["qn_roll_update"] == \
        before["qn_roll_update"] + 1
    want = kernels.qn_roll_update_plain_batched(buf, s, y, upd)
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    assert torch.equal(got[0], want[0])
    assert_close(got[1], want[1], rtol=rtol,
                 atol=rtol * float(want[1].abs().max()))
    for i in range(KB):
        one = kernels.qn_roll_update(buf[i], s[i], y[i], upd[i])
        assert _bitwise((got[0][i], got[1][i]), one)
    one = kernels.qn_roll_update_batched(buf[:1], s[:1], y[:1], upd[:1])
    assert _bitwise((one[0][0], one[1][0]),
                    kernels.qn_roll_update(buf[0], s[0], y[0], upd[0]))
    shared = kernels.qn_roll_update_batched(buf[0].expand(KB, 20, 5000), s,
                                            y, upd)
    for i in range(KB):
        assert _bitwise((shared[0][i], shared[1][i]),
                        kernels.qn_roll_update(buf[0], s[i], y[i], upd[i]))
    # under torch.func.vmap: one instance-axis launch
    before = kernels.LAUNCHES["qn_roll_update"]
    vm = torch.func.vmap(kernels.qn_roll_update)(buf, s, y, upd)
    assert kernels.LAUNCHES["qn_roll_update"] == before + 1
    assert _bitwise(vm, got)


@pytest.mark.parametrize("shared_vals", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,k,nwcon", [(1, 8, 4096), (21, 8, 1000),
                                       (3, 13, 1001)])
def test_cuda_quasi_def_instance_axis(cuda, K, k, nwcon, dtype,
                                      shared_vals):
    ops = _stack_inputs(K, k, nwcon, dtype, cuda, shared_vals)
    got = kernels.quasi_def_apply_batched(*ops)
    _held_to_plain(got, kernels.quasi_def_apply_plain_batched(*ops), dtype)
    for i in range(KB):
        assert _bitwise((got[0][i], got[1][i]),
                        kernels.quasi_def_apply(*(o[i] for o in ops)))
    one = kernels.quasi_def_apply_batched(*(o[:1] for o in ops))
    assert _bitwise((one[0][0], one[1][0]),
                    kernels.quasi_def_apply(*(o[0] for o in ops)))
    before = kernels.LAUNCHES["quasi_def_apply"]
    vm = torch.func.vmap(kernels.quasi_def_apply,
                         in_dims=(0, 0, None if shared_vals else 0, 0, 0))(
        ops[0], ops[1], ops[2][0] if shared_vals else ops[2], ops[3],
        ops[4])
    assert kernels.LAUNCHES["quasi_def_apply"] == before + 1
    assert _bitwise(vm, got)


@pytest.mark.parametrize("shared_vals", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kb,B,k,nwcon", [
    (KB, 21, 8, 4096), (KB, 21, 8, 1000), (KB, 7, 13, 1001),
    (35, 21, 8, 512), (5, 21, 8, 4096), (9, 21, 8, 1000), (5, 21, 1, 4096)])
def test_cuda_phi_gram_instance_axis(cuda, kb, B, k, nwcon, dtype,
                                     shared_vals):
    """With bw and the stack whole, and as the factor setup calls it (two
    row blocks, bw = 0).  The last four rows give the persistent grid
    more virtual blocks than physical ones (kb·nb > 264 on an H100's 132
    SMs, never a multiple of 264), nwcon = 1000 a ragged last tile; at
    k = 1 the Gram reduction has a shared-memory region of its own."""
    dinv, cwinv, vals, bx, bw = _stack_inputs(B, k, nwcon, dtype, cuda,
                                              shared_vals, kb)
    top = B - 1
    for args in ((dinv, cwinv, vals, bx, bw, None),
                 (dinv, cwinv, vals, bx[:, :top], None, bx[:, top:])):
        got = kernels.phi_gram_batched(*args)
        _held_to_plain(got, kernels.phi_gram_plain_batched(*args), dtype)
        for i in range(kb):
            one = kernels.phi_gram(*(None if a is None else a[i]
                                     for a in args))
            assert _bitwise((g[i] for g in got), one)
        one = kernels.phi_gram_batched(*(None if a is None else a[:1]
                                         for a in args))
        assert _bitwise((g[0] for g in one),
                        kernels.phi_gram(*(None if a is None else a[0]
                                           for a in args)))
    before = kernels.LAUNCHES["phi_gram"]
    vm = torch.func.vmap(kernels.phi_gram,
                         in_dims=(0, 0, 0, 0, None, 0))(*args)
    assert kernels.LAUNCHES["phi_gram"] == before + 1
    assert _bitwise(vm, got)


def test_cuda_batched_solves_launch_the_instance_axis_and_match_host(cuda):
    """`FusedIP.solve_batched` and `FusedTR.solve_batched` on
    SyntheticTopology(4096) in float64, k = 3: on the card every kernel
    launch is an instance-axis launch and the card run takes the host run's
    iterations, fobj to 1e-9 per instance."""
    import numpy as np
    from paropt_torch import ip_fused
    from paropt_torch.ops import qn
    n = 4096
    out = {}
    for dev in (cuda, torch.device("cpu")):
        prob = SyntheticTopology(n=n, block=8, dtype=torch.float64,
                                 device=dev)
        x0, _, _ = prob.get_vars_and_bounds()
        rng = np.random.default_rng(0)
        x0s = x0[None] * torch.as_tensor(rng.uniform(0.5, 1.5, (3, n)),
                                         device=dev)
        kernels.reset_launches()
        fused = ip_fused.FusedIP(
            ip_fused.model_from_problem(prob), n, 1, prob.nwcon, 1,
            ip_fused.FusedIPOptions(use_quasi_newton_update=True,
                                    abs_res_tol=1e-6), dtype=torch.float64)
        data, _ = ip_fused.data_template_from_problem(prob,
                                                      dtype=torch.float64)
        st = fused.solve_batched(x0s, data, (),
                                 qn.qn_init(10, n, dtype=torch.float64,
                                            device=dev))
        res, _ = FusedTR(prob, {"tr_output_file": None, "output_file": None,
                                "tr_max_iterations": 4,
                                "abs_res_tol": 1e-8}).solve_batched(x0s)
        out[dev.type] = (st.k.tolist(), st.fobj.cpu().numpy(),
                         res["niter"], res["fobj"], dict(kernels.LAUNCHES),
                         dict(kernels.BATCHED_LAUNCHES))
    kc, fc, tnc, tfc, lc, bc = out["cuda"]
    kh, fh, tnh, tfh, lh, _ = out["cpu"]
    assert all(n > 0 for n in lc.values()) and lc == bc, (lc, bc)
    assert not any(lh.values())
    assert kc == kh and list(tnc) == list(tnh)
    np.testing.assert_allclose(fc, fh, rtol=1e-9)
    np.testing.assert_allclose(tfc, tfh, rtol=1e-9)


DYMOS = {"norm_type": "infinity", "qn_subspace_size": 10,
         "starting_point_strategy": "least_squares_multipliers",
         "qn_update_type": "damped_update", "abs_res_tol": 1e-6,
         "barrier_strategy": "monotone", "armijo_constant": 1e-5,
         "penalty_gamma": 100.0, "max_major_iters": 500}


@pytest.mark.parametrize("model", ["electron_csr", "brachistochrone"])
def test_cuda_csr_path_matches_the_cpu(cuda, model):
    """The general-CSR path in float64 through the host InteriorPoint on
    the card and on the CPU: equal counts, fobj within 1e-9 relative, no
    quasi-definite kernel on the card; the native library is built from
    src_native/ into build/paropt_torch_sparse/."""
    from paropt_torch import InteriorPoint
    from paropt_torch.models import BrachistochroneCollocation, ElectronCSR
    from paropt_torch.ops import sparse_native

    def run(device):
        if model == "electron_csr":
            prob = ElectronCSR(20, dtype=torch.float64, device=device)
            opts = {"abs_res_tol": 1e-6}
        else:
            prob = BrachistochroneCollocation(24, dtype=torch.float64,
                                              device=device)
            opts = DYMOS
        kernels.reset_launches()
        ip = InteriorPoint(prob, dict(opts, output_file=None))
        res = ip.optimize()
        return res, dict(kernels.LAUNCHES), ip

    rc, launches, ip = run(cuda)
    rh, _, _ = run("cpu")
    assert rc["converged"] and rc["x"].is_cuda
    assert (rc["niter"], rc["neval"], rc["ngeval"]) == (
        rh["niter"], rh["neval"], rh["ngeval"])
    assert abs(rc["fobj"] - rh["fobj"]) <= 1e-9 * abs(rh["fobj"])
    assert launches["qn_roll_update"] > 0
    assert launches["quasi_def_apply"] == launches["phi_gram"] == 0
    assert ip.syncs.bytes_to_host > 0 and ip.syncs.bytes_to_device > 0
    lib = sparse_native.build_library()
    assert lib.parts[-4:-2] == ("build", "paropt_torch_sparse")


def test_cuda_batched_lobpcg_matches_single_solves(cuda):
    """The batched LOBPCG on the card against its single solves, instance
    by instance, in float64: the same block-iteration counts (two early
    exits at different counts and one capped instance) and eigenvalues
    within 1e-9 relative (batched eigh and qr need not round as the
    single calls do); one host read per block iteration."""
    import numpy as np

    from paropt_torch.ip import HostSyncs
    from paropt_torch.ops import lobpcg
    n, k, m = 200, 4, 40
    tops = ((10, [20, 16, 12, 8, 4]), (11, [10, 9, 8, 7, 3]),
            (12, [1 + 1e-3 * i for i in range(8)][::-1]))
    As, Xs = [], []
    for seed, top in tops:
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        ev = np.concatenate([top, rng.uniform(0.1, 1.0, n - len(top))])
        As.append((Q * ev) @ Q.T)
        Xs.append(rng.standard_normal((n, k)))
    A = torch.tensor(np.stack(As), device=cuda)
    X = torch.tensor(np.stack(Xs), device=cuda)
    syncs = HostSyncs()
    theta, U, iters = lobpcg.lobpcg_standard_batched(lambda v: A @ v, X,
                                                     m=m, syncs=syncs)
    assert theta.device.type == "cuda" and syncs.count == max(iters) == m
    for j in range(len(tops)):
        t1, U1, i1 = lobpcg.lobpcg_standard(lambda v: A[j] @ v, X[j], m=m)
        assert iters[j] == i1
        assert_close(theta[j], t1, rtol=1e-9)


# ---------------------------------------------------------------------------
# the kernels on sharded state (DTensor over a world-size-1 NCCL mesh)
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    import torch.distributed as dist
    from paropt_torch.parallel.sharding import design_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        yield design_mesh("cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_sharded_route_launches_the_kernels(nccl_mesh, dtype,
                                                 monkeypatch):
    """Each op on CUDA DTensors placed as the main path places them
    launches its kernel on the rank's shard, once, and equals the
    unsharded launch bit for bit; the plain versions are never reached
    (each is replaced by one that raises)."""
    from paropt_torch.parallel.worker import op_inputs, place_ops, run_ops
    ops = {k: v.to(nccl_mesh.device_type)
           for k, v in op_inputs(1 << 16, 1, 21, 10, dtype).items()}
    want = run_ops(ops, kernels)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("qn_roll_update_plain", "quasi_def_apply_plain",
                 "phi_gram_plain"):
        monkeypatch.setattr(kernels, name, refuse)
    kernels.reset_launches()
    got = run_ops(place_ops(ops, nccl_mesh), kernels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"qn_roll_update": 1, "quasi_def_apply": 1,
                                "phi_gram": 1}
    for key, val in want.items():
        assert torch.equal(got[key].full_tensor(), val), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_fem_strip_solve_matches_plain(nccl_mesh, dtype):
    """FEMTopology(64, 32)'s state solve on its x-strip over a one-rank
    NCCL mesh (`parallel.halo`: the halos have no neighbour, the dots sum
    the owned rows, the V-cycle gathers at its gather level) equals the
    plain solve bit for bit on the card, and so do the sharded
    evaluations."""
    from paropt_torch.models.fem_topology import FEMTopology
    from paropt_torch.parallel.sharding import shard_design
    prob = FEMTopology(64, 32, cg_iters=25, solver="mgcg", dtype=dtype,
                       device=nccl_mesh.device_type)
    x0, _, _ = prob.get_vars_and_bounds()
    x = x0 * torch.linspace(0.5, 1.5, prob.nvars, dtype=dtype,
                            device=x0.device)
    E = prob._simp(prob._filter(x))
    view = prob._strip_view(nccl_mesh)
    u = view._solve(shard_design(E, nccl_mesh).to_local())
    assert torch.equal(u, prob._solve(E))
    xs = shard_design(x, nccl_mesh)
    for got, want in zip(
            prob.eval_obj_con(xs) + prob.eval_obj_con_gradient(xs),
            prob.eval_obj_con(x) + prob.eval_obj_con_gradient(x)):
        assert torch.equal(got.full_tensor(), want)
