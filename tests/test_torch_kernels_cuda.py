"""Each CUDA kernel of paropt_torch against its plain PyTorch version, on a
card; every test here is marked ``cuda`` and skips without one (the `cuda`
fixture decides, at run time).  The file imports no jax, so on a machine
with a card and no jax it runs without the JAX conftest:

    python -m pytest tests/test_torch_kernels_cuda.py -q -p no:cacheprovider --noconftest

Tolerances: f64 1e-12 relative (exposes indexing faults); f32 and bf16
storage (f32 accumulation) 1e-5, the reordering of the sums."""

import pytest
import torch

from paropt_torch.ops import kernels

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
