"""The kernels' byte model against the bound column of PERF.md's kernel
table: the main path's shapes (n = 2^20, msub = 10, block 8) and the
instance-axis launch at kb = 4 (vals shared by the instances)."""

import pytest

from portbench import roofline

N = 1 << 20
M = 10
K = 8
W = N // K
B = 2 * M + 1


def mb(nbytes):
    return round(nbytes / 1e6, 1)


@pytest.mark.parametrize("kb, want", [(None, 176.2), (4, 704.6)])
def test_qn_roll_update_bytes(kb, want):
    lead = [kb] if kb else []
    nbytes, flops = roofline.qn_roll_update(lead + [2 * M, N], lead + [N],
                                            lead + [N], lead)
    assert mb(nbytes) == want
    assert flops == (kb or 1) * 4 * 2 * M * N


@pytest.mark.parametrize("kb, want", [(None, 18.4), (4, 60.8)])
def test_quasi_def_apply_bytes(kb, want):
    lead = [kb] if kb else []
    nbytes, flops = roofline.quasi_def_apply(
        lead + [K, W], lead + [W], lead + [K, W], lead + [1, K, W],
        lead + [1, W], vals_shared=bool(kb))
    assert mb(nbytes) == want
    assert flops == (kb or 1) * W * (6 * K + 2)


@pytest.mark.parametrize("kb, want", [(None, 196.1), (4, 771.8)])
def test_phi_gram_bytes(kb, want):
    lead = [kb] if kb else []
    # as the factor setup calls it: the QN rows, then A's row, bw = 0
    nbytes, flops = roofline.phi_gram(
        lead + [K, W], lead + [W], lead + [K, W], lead + [2 * M, K, W], None,
        lead + [1, K, W], vals_shared=bool(kb))
    assert mb(nbytes) == want
    assert flops == (kb or 1) * (2 * B * B * K * W + B * W * (6 * K + 2))


def test_bound_takes_the_larger_rate():
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_call_bound_reads_logged_dims():
    dims = [[K, W], [W], [K, W], [1, K, W], [1, W]]
    want = roofline.bound_s(*roofline.quasi_def_apply(*dims))
    assert roofline.call_bound_s("paropt::quasi_def_apply", dims, 4) == want
    pg = [[K, W], [W], [K, W], [2 * M, K, W], [], [1, K, W]]
    assert roofline.call_bound_s("paropt::phi_gram", pg, 4) == \
        roofline.bound_s(*roofline.phi_gram(*[d or None for d in pg]))
