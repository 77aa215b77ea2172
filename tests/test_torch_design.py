"""PyTorch port: density evolution and irregular code design against the
JAX package, on tests/test_design.py's cases and seeds.

The module is host numpy and scipy in both packages, so the bar is
equality: the same thresholds, distributions and H (bit for bit) on the
same seeds, and the same code files. The textbook anchors of
tests/test_design.py hold too: the (3,6)-regular BEC BP threshold ~0.4294,
a rate-1/2 lambda for rho(x) = x^5 between it and capacity, and a sampled
code that decodes on the BEC below threshold.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoders_tpu.design import density_evolution as jax_de  # noqa: E402
from ldpc_decoders_tpu_torch.channels import bec  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.design import (  # noqa: E402
    gen_rand_irg_ldpc,
    rate_from_polys,
    reg_pol,
    solve_dist,
    solve_eps_bp,
)
from ldpc_decoders_tpu_torch.design import density_evolution as de  # noqa: E402


@pytest.fixture(scope="module")
def dists():
    return (solve_dist("rho5", 0.5, reg_pol(5)),
            jax_de.solve_dist("rho5", 0.5, jax_de.reg_pol(5)))


def test_36_regular_threshold():
    eps = solve_eps_bp(reg_pol(2), reg_pol(5))
    assert abs(eps - 0.4294) < 2e-3, eps
    assert eps == jax_de.solve_eps_bp(jax_de.reg_pol(2), jax_de.reg_pol(5))


def test_rate_formula_and_de_values():
    assert abs(rate_from_polys(reg_pol(2), reg_pol(5)) - 0.5) < 1e-12
    lam, rho = [0.3, 0.2, 0.5, 0.0], [0.6, 0.0, 0.4, 0.0, 0.0]
    assert rate_from_polys(lam, rho) == jax_de.rate_from_polys(lam, rho)
    xs = np.linspace(0.0, 1.0, 101)
    np.testing.assert_array_equal(de.de_step(0.45, lam, rho, xs),
                                  jax_de.de_step(0.45, lam, rho, xs))
    np.testing.assert_array_equal(de.get_node_dist(lam),
                                  jax_de.get_node_dist(lam))
    assert de.pol2str(lam) == jax_de.pol2str(lam)


def test_solve_dist_rate_and_threshold(dists):
    d, want = dists
    assert abs(d.rate - 0.5) < 1e-3
    assert 0.45 < d.thresh < 0.5, d.thresh
    assert abs(sum(d.lambda_p) - 1.0) < 1e-6
    assert all(c >= -1e-9 for c in d.lambda_p)
    assert (d.name, d.lambda_p, d.rho_p, d.thresh) == \
        (want.name, want.lambda_p, want.rho_p, want.thresh)


def test_sample_irregular_parity_structure(dists):
    d, want = dists
    H = de.sample_irregular_parity(np.random.default_rng(0), d, num_var=1200)
    np.testing.assert_array_equal(H, jax_de.sample_irregular_parity(
        np.random.default_rng(0), want, num_var=1200))
    chk_deg = H.sum(axis=1)
    assert chk_deg.max() <= 6
    assert (chk_deg == 6).mean() > 0.9
    assert abs(1.0 - H.shape[0] / H.shape[1] - 0.5) < 0.03
    var_deg = H.sum(axis=0)
    assert (var_deg >= 1).mean() > 0.99
    assert (var_deg >= 2).mean() > 0.95
    with pytest.raises(ValueError, match="degree-3 bucket"):
        de._node_degree_counts([1.0, 0.0, 0.0], 7, 4)


def test_gen_rand_irg_ldpc_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("FILE_CODES_DIR", str(tmp_path / "port"))
    names = gen_rand_irg_ldpc(2, 600, 5, 0.5, seed=1,
                              dir_path=str(tmp_path / "port"))
    assert names == ["600_rho_x5_rand_ldpc_1", "600_rho_x5_rand_ldpc_2"]
    assert names == jax_de.gen_rand_irg_ldpc(2, 600, 5, 0.5, seed=1,
                                             dir_path=str(tmp_path / "jax"))
    for name in names:
        assert (tmp_path / "port" / f"{name}.txt").read_bytes() == \
            (tmp_path / "jax" / f"{name}.txt").read_bytes()
    code = get_code(names[0])
    assert code.get_n() == 600
    # The sampled code decodes on the BEC below its threshold (~0.48).
    dec = bec.DECODERS["SPA"](code, max_iter=50, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = torch.zeros((64, 600), dtype=torch.int32)
    x_hat, _ = dec.decode(bec.send(x, 0.3, gen), 0.3)
    ber = float((x_hat != 0).float().mean())
    assert ber < 0.01, ber


def test_cli_irg_equals_jax(tmp_path, capsys):
    argv = ["irg", "--count", "1", "--len", "300", "--seed", "2"]
    jax_de.main(argv + ["--out", str(tmp_path / "jax")])
    want = capsys.readouterr().out
    de.main(argv + ["--out", str(tmp_path / "port")])
    assert capsys.readouterr().out == want == "300_rho_x5_rand_ldpc_1\n"
    assert (tmp_path / "port" / "300_rho_x5_rand_ldpc_1.txt").read_bytes() == \
        (tmp_path / "jax" / "300_rho_x5_rand_ldpc_1.txt").read_bytes()
