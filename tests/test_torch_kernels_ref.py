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


@pytest.mark.parametrize("top", [7, 4])
def test_phi_gram_split_stack_without_bw_matches_pallas(top):
    """The factor setup's call: the stack as two row blocks and no bw, held
    against the Pallas kernel on the concatenated stack with bw = 0."""
    dinv, cwinv, vals, bx, _ = qd_inputs(7, 4, 128, seed=20 + top)
    jout = pk.phi_gram_blocked_t(
        *(jnp.asarray(a) for a in (dinv, cwinv, vals, bx)),
        jnp.zeros((7, 128)), interpret=True)
    t = [torch.as_tensor(a) for a in (dinv, cwinv, vals, bx)]
    tail = t[3][top:] if top < 7 else None
    tout = kernels.phi_gram(*t[:3], t[3][:top], None, tail)
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
    with pytest.raises(ValueError, match="bx_tail"):
        kernels.phi_gram(*args[:4], None, args[3][:, :3])
    with pytest.raises(ValueError, match="bw"):
        kernels.phi_gram(*args[:4], args[4], args[3])


def test_phi_gram_plan_main_path():
    """B = 2·10 + 1, k = 8 in f32 as the factor setup calls it (no bw):
    32-column tiles, B padded to 24 (six 4 x 4 micro-tiles a side), an odd
    31 slots a chunk, two blocks of 99,584 bytes on each SM; f64 halves the
    tile."""
    plan = kernels.phi_gram_plan(21, 8, 4, has_bw=False)
    assert plan == (32, 24, 31, 1, 99584, 2)
    assert kernels.phi_gram_tile(21, 8, 4) == 32
    assert plan.smem == 4 * kernels._pg_smem_elems(21, 8, 32, 31, False)
    assert kernels.phi_gram_plan(21, 8, 8, has_bw=False) == (16, 24, 31, 1,
                                                             99584, 2)


def test_phi_gram_reduction_shares_the_ring_where_it_fits():
    """The Gram reduction of a virtual block's end (7 threads × 36
    micro-tiles × 16 at B = 21) goes to the consumed stage and the tile's
    yx, two stages, where it fits (k = 8: no extra shared memory); at
    k = 1 two stages hold 1,984 elements and it gets 4,032 of its own."""
    ring = 2 * (2 * 8 * 32 + 32)
    assert kernels._pg_smem_elems(21, 8, 32, 31, False) == 3 * 7936 + ring
    ring = 2 * (2 * 1 * 32 + 32)
    assert kernels._pg_smem_elems(21, 1, 32, 31, False) == (3 * 992 + ring
                                                            + 4032)


@pytest.mark.parametrize("kb,W,itemsize,sms", [
    (4, 1 << 17, 4, 132), (1, 1 << 17, 4, 132), (32, 512, 4, 132),
    (33, 512, 4, 132), (5, 4096, 8, 132), (3, 1000, 4, 7), (2, 100, 8, 3)])
def test_phi_gram_grid_walks_each_virtual_block_once(kb, W, itemsize, sms):
    """The instance-axis launch's persistent grid on a card of ``sms`` SMs
    (B = 21, k = 8 as the factor setup calls it): nb, the virtual blocks
    of each instance, is the single launch's grid; at most
    blocks_per_sm × SMs physical blocks walk the kb·nb virtual blocks,
    each (instance, block) exactly once, and each instance's tiles fall
    to its blocks as in the single launch, every tile once."""
    plan = kernels.phi_gram_plan(21, 8, itemsize, has_bw=False)
    resident = plan.blocks_per_sm * sms
    ntiles = -(-W // plan.tile)
    nb, grid = kernels.phi_gram_grid(plan, W, sms, kb)
    assert (nb, nb) == kernels.phi_gram_grid(plan, W, sms)
    assert nb == min(ntiles, resident)
    assert grid == min(kb * nb, resident) <= resident
    owner, per_instance = {}, {}
    for g in range(grid):
        walk = kernels.phi_gram_walk(nb, grid, kb, ntiles, g)
        assert walk, f"physical block {g} has no work"
        for i, b, tiles in walk:
            assert (i, b) not in owner
            owner[i, b] = g
            per_instance.setdefault(i, {})[b] = tiles
    assert set(owner) == {(i, b) for i in range(kb) for b in range(nb)}
    single = {b: tiles for g in range(nb)
              for _, b, tiles in kernels.phi_gram_walk(nb, nb, 1, ntiles,
                                                       g)}
    assert sorted(t for ts in single.values() for t in ts) == list(
        range(ntiles))
    for i in range(kb):
        assert per_instance[i] == single


def test_phi_gram_grid_main_path_shapes():
    """Phase 3b's kb = 4 at nwcon = 2^17: one wave of 264 blocks, block g
    taking one block of each instance in turn, rotated by 4096 % 264 =
    136 per instance so that no physical block walks more than
    ceil(4 · 4096 / 264) = 63 tiles (64 without the rotation); phase 22's
    kb = 32 at nwcon = 512 (16 tiles): 264 blocks over 512 virtual
    blocks, 248 of them taking two."""
    plan = kernels.phi_gram_plan(21, 8, 4, has_bw=False)
    assert kernels.phi_gram_grid(plan, 1 << 17, 132, 4) == (264, 264)
    walk = kernels.phi_gram_walk(264, 264, 4, 4096, 7)
    assert [(i, b) for i, b, _ in walk] == [(0, 7), (1, 143), (2, 15),
                                            (3, 151)]
    assert max(sum(len(t) for _, _, t in kernels.phi_gram_walk(
        264, 264, 4, 4096, g)) for g in range(264)) == 63
    assert kernels.phi_gram_grid(plan, 512, 132, 32) == (16, 264)
    counts = [len(kernels.phi_gram_walk(16, 264, 32, 16, g))
              for g in range(264)]
    assert counts.count(2) == 248 and counts.count(1) == 16


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [1, 8, 13])
@pytest.mark.parametrize("B", [1, 7, 21, 22, 64, 65, 128, 129])
def test_phi_gram_plan_fits_or_refuses(B, k, itemsize):
    """Every plan pads B to the 4 x 4 micro-tiles, gives each thread at
    most four of them, keeps the slot count odd and the stage within the
    SM's shared memory; a stack past 128 rows or too wide for a 4-column
    tile is refused with "stack too tall"."""
    try:
        plan = kernels.phi_gram_plan(B, k, itemsize)
    except ValueError as e:
        assert "stack too tall" in str(e)
        assert B > 64
        return
    assert plan.bpad % 4 == 0 and B <= plan.bpad < B + 4
    assert plan.slots % 2 == 1 and plan.slots >= plan.bpad + plan.bpad // 4
    assert (plan.bpad // 4) ** 2 <= 256 * plan.mt and plan.mt in (1, 2, 4)
    assert plan.tile % 4 == 0
    budget = 228 * 1024 // plan.blocks_per_sm - 1024
    assert plan.smem <= min(budget, 227 * 1024)
    assert plan.smem >= itemsize * kernels._pg_smem_elems(
        B, k, plan.tile, plan.slots, True)
    if B <= 22 and k <= 8:
        assert plan.blocks_per_sm == 2


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
