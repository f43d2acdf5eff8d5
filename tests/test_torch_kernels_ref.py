"""paropt_torch.ops.kernels: each plain PyTorch version against its Pallas
kernel run in interpret mode (as tests/test_pallas.py runs them), the
wrappers' routing and checks on the CPU, and the kernels' build.  The CUDA
kernels themselves are held against their plain versions in
tests/test_torch_kernels_cuda.py, on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paropt_tpu.ops import pallas_kernels as pk
from paropt_torch.ops import kernels

from ._torch_parity import assert_close, np_of, qd_inputs

torch.set_num_threads(1)

# f64 tolerance: the same arithmetic in another summation order, a few ulps
RTOL64 = 1e-12


@pytest.mark.parametrize("upd", [True, False])
@pytest.mark.parametrize("n", [1024, 1000])
def test_qn_roll_plain_matches_pallas_f64(upd, n):
    rng = np.random.default_rng(7)
    m = 4
    buf, s, y = (rng.standard_normal((2 * m, n)), rng.standard_normal(n),
                 rng.standard_normal(n))
    jo, jd = pk.qn_roll_update(jnp.asarray(buf), jnp.asarray(s),
                               jnp.asarray(y), jnp.asarray(upd),
                               interpret=True)
    to, td = kernels.qn_roll_update_plain(
        torch.as_tensor(buf), torch.as_tensor(s), torch.as_tensor(y),
        torch.tensor(upd))
    assert np.array_equal(np_of(to), np_of(jo))
    assert td.dtype == torch.float64
    assert_close(td, jd, rtol=RTOL64, atol=1e-12)


def test_qn_roll_plain_matches_pallas_bf16_storage():
    """bf16 buffer, f32 (s, y): the rolled buffer holds the quantized pair
    bit for bit; the dots accumulate in f32 from the quantized values
    (tolerance: f32 summation order over n = 2048 terms)."""
    rng = np.random.default_rng(8)
    m, n = 3, 2048
    buf = rng.standard_normal((2 * m, n)).astype(np.float32)
    s = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    jbuf = jnp.asarray(buf).astype(jnp.bfloat16)
    tbuf = torch.as_tensor(buf).to(torch.bfloat16)
    assert np.array_equal(np_of(jbuf), np_of(tbuf))
    jo, jd = pk.qn_roll_update(jbuf, jnp.asarray(s), jnp.asarray(y),
                               jnp.asarray(True), interpret=True)
    to, td = kernels.qn_roll_update_plain(tbuf, torch.as_tensor(s),
                                          torch.as_tensor(y),
                                          torch.tensor(True))
    assert to.dtype == torch.bfloat16 and td.dtype == torch.float32
    assert np.array_equal(np_of(to), np_of(jo))
    assert_close(td, jd, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("K,nwcon", [(1, 256), (5, 256), (3, 100)])
def test_quasi_def_plain_matches_pallas(K, nwcon):
    args = qd_inputs(K, 4, nwcon, seed=K)
    jyx, jyw = pk.quasi_def_apply_blocked_t(
        *(jnp.asarray(a) for a in args), interpret=True)
    tyx, tyw = kernels.quasi_def_apply_plain(
        *(torch.as_tensor(a) for a in args))
    assert_close(tyx, jyx, rtol=RTOL64, atol=1e-13)
    assert_close(tyw, jyw, rtol=RTOL64, atol=1e-13)


@pytest.mark.parametrize("B,nwcon", [(7, 256), (5, 100)])
def test_phi_gram_plain_matches_pallas(B, nwcon):
    args = qd_inputs(B, 4, nwcon, seed=10 + B)
    jout = pk.phi_gram_blocked_t(*(jnp.asarray(a) for a in args),
                                 interpret=True)
    tout = kernels.phi_gram_plain(*(torch.as_tensor(a) for a in args))
    for got, want in zip(tout, jout):
        assert_close(got, want, rtol=RTOL64, atol=1e-11)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU every wrapper returns its plain version's result and
    launches nothing."""
    kernels.reset_launches()
    args = [torch.as_tensor(a) for a in qd_inputs(3, 4, 64, seed=1)]
    for wrapper, plain in ((kernels.quasi_def_apply,
                            kernels.quasi_def_apply_plain),
                           (kernels.phi_gram, kernels.phi_gram_plain)):
        for got, want in zip(wrapper(*args), plain(*args)):
            assert torch.equal(got, want)
    buf, s, y = (torch.randn(shape, dtype=torch.float64)
                 for shape in ((6, 64), (64,), (64,)))
    upd = torch.tensor(True)
    for got, want in zip(kernels.qn_roll_update(buf, s, y, upd),
                         kernels.qn_roll_update_plain(buf, s, y, upd)):
        assert torch.equal(got, want)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_wrappers_reject_bad_operands():
    args = [torch.as_tensor(a) for a in qd_inputs(2, 4, 64, seed=2)]
    with pytest.raises(ValueError):
        kernels.quasi_def_apply(args[0], args[1], args[2], args[3][:, :3],
                                args[4])
    with pytest.raises(ValueError):
        kernels.phi_gram(args[0].float(), *args[1:])
    with pytest.raises(ValueError):
        kernels.qn_roll_update(torch.zeros(5, 8), torch.zeros(8),
                               torch.zeros(8), torch.tensor(True))
    with pytest.raises(ValueError):
        kernels.qn_roll_update(torch.zeros(4, 8), torch.zeros(8),
                               torch.zeros(8), torch.tensor(1.0))
    with pytest.raises(ValueError):
        kernels.phi_gram_tile(B=400, k=64, itemsize=8)


# -- the build ---------------------------------------------------------------


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """The library's directory is a hash of the CUDA sources and flags: an
    edited source builds anew."""
    from paropt_torch.ops import _build
    (tmp_path / "a.cu").write_text("// one\n")
    (tmp_path / "b.cuh").write_text("// header\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    h1 = _build.source_hash()
    assert h1 == _build.source_hash()
    (tmp_path / "b.cuh").write_text("// header, edited\n")
    assert _build.source_hash() != h1


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A compiler that fails makes the first launch raise (no fallback),
    and nothing is left where the library would be."""
    from paropt_torch.ops import _build
    script = tmp_path / "fake_nvcc"
    script.write_text("#!/bin/sh\necho 'error: no such card' >&2\nexit 3\n")
    script.chmod(0o755)
    monkeypatch.setattr(_build, "_find_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such card"):
        _build.build_library()
    lib_dir = tmp_path / "build" / _build.source_hash()
    assert not (lib_dir / _build.LIB_NAME).exists()


def test_unsupported_device_is_refused():
    meta = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.qn_roll_update(meta, torch.empty(8, device="meta"),
                               torch.empty(8, device="meta"),
                               torch.empty((), dtype=torch.bool,
                                           device="meta"))
