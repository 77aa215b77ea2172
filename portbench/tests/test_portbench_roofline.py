"""The work counts reproduce the bounds the program's chip smoke run
states for min-sum (kernel table row #1), ADMM's update term and the chunk
kernels C1 and C2 at their shapes."""

import pytest

import chip_smoke
from portbench import roofline

B, N, E = 16384, 1200, 3600


def test_peaks_are_the_smoke_runs():
    assert roofline.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert roofline.F32_OPS_PER_S == chip_smoke.F32_OPS_PER_S
    assert roofline.MSA_OPS_PER_EDGE_ITER == \
        chip_smoke.OPS_PER_EDGE_ITER["msa_decode"]


def test_minsum_row_1():
    # row #1: bf16 3.0 dB, B=16384, 5.82 iterations a word: bound 0.0615 ms
    # by operations, bytes 0.0470 ms
    n_bytes, n_ops = roofline.msa_decode(B, 95382, N, E)
    assert n_bytes == B * (4 * N * 2 + 4)
    assert 1e3 * n_bytes / roofline.HBM_BYTES_PER_S == pytest.approx(
        0.0470, abs=5e-5)
    assert 1e3 * roofline.bound_s(n_bytes, n_ops) == pytest.approx(
        0.0615, abs=5e-5)


def test_admm_updates_are_the_smoke_runs_without_the_bracket():
    got = roofline.admm_update_ops(1000, 7920, 2640, 6)
    assert got == pytest.approx(chip_smoke.admm_ops(1000, 0, 7920, 2640, 6))
    assert got < chip_smoke.admm_ops(1000, 10, 7920, 2640, 6)


def test_chunk_kernels_c1_c2():
    assert 1e3 * roofline.bound_s(roofline.transmit(B, N), 0) == \
        pytest.approx(0.0470, abs=5e-5)
    assert 1e3 * roofline.bound_s(roofline.tally(B, 1, N, False), 0) == \
        pytest.approx(0.0235, abs=5e-5)
