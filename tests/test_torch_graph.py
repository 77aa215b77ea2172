"""PyTorch port: codes and Tanner-graph tables against the JAX package.

The port builds its tables in numpy and holds them as torch tensors; every
field must equal the JAX package's for every code the repository ships
(the 27 parity files and the 4 built-ins)."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from ldpc_decoders_tpu.codes import code as jax_code  # noqa: E402
from ldpc_decoders_tpu.ops import graph as jax_graph  # noqa: E402
from ldpc_decoders_tpu_torch.codes import code as port_code  # noqa: E402
from ldpc_decoders_tpu_torch.ops.graph import (  # noqa: E402
    TannerGraph,
    exclusive_sign_parity,
    exclusive_sum,
)

_CODES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "codes")
FILE_CODES = sorted(os.path.splitext(f)[0] for f in os.listdir(_CODES_DIR))
ALL_CODES = list(port_code.BUILTIN_CODES) + FILE_CODES


def _jax_dict(g) -> dict:
    return {f.name: (getattr(g, f.name) if f.name == "chk_degrees"
                     else np.asarray(getattr(g, f.name)))
            for f in dataclasses.fields(g)}


def test_all_codes_listed():
    assert len(FILE_CODES) == 27
    assert port_code.get_code_names() == jax_code.get_code_names()


@pytest.mark.parametrize("name", ALL_CODES)
def test_graph_tables_equal_jax(name):
    jc, pc = jax_code.get_code(name), port_code.get_code(name)
    np.testing.assert_array_equal(pc.parity_mtx, jc.parity_mtx)
    if jc.cb is not None:
        np.testing.assert_array_equal(pc.cb, jc.cb)
    want = _jax_dict(jc.graph)
    got = pc.graph.as_numpy_dict()
    assert pc.graph.chk_degrees == want.pop("chk_degrees")
    assert pc.graph.device == torch.device("cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(got[k], np.ndarray):
            assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_from_jax_graph_round_trip():
    jg = jax_code.get_code("1200_rho_x5_rand_ldpc_1").graph
    d = _jax_dict(jg)
    d.pop("chk_degrees")
    pg = TannerGraph.from_jax_graph(d)
    assert pg.chk_degrees == jg.chk_degrees
    back = pg.as_numpy_dict()
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    again = TannerGraph.from_jax_graph(back).as_numpy_dict()
    for k, v in back.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    assert pg.to("cpu") is pg


def test_exclusive_sign_parity_matches_jax():
    rng = np.random.default_rng(5)
    neg = rng.integers(0, 2, size=(64, 600, 6)).astype(np.int32)
    want = np.asarray(jax_graph.exclusive_sign_parity(jnp.asarray(neg)))
    got = exclusive_sign_parity(torch.from_numpy(neg)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [1, 4, 6])
def test_exclusive_sum_matches_jax(d):
    """Leave-one-out sums folded in slot order: bit-equal to the JAX
    package's prefix/suffix cumsums (XLA-CPU folds them in order too) on
    phi-like values spanning many magnitudes."""
    rng = np.random.default_rng(d)
    x = np.exp(rng.uniform(-38, 3.7, size=(64, 600, d))).astype(np.float32)
    want = np.asarray(jax_graph.exclusive_sum(jnp.asarray(x)))
    got = exclusive_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_parity_file_round_trip(tmp_path):
    H = port_code.get_code("1200_3_6_rand_ldpc_1").parity_mtx
    path = port_code.save_parity_mtx(H, "rt", str(tmp_path))
    np.testing.assert_array_equal(port_code.load_parity_mtx(path), H)
    np.testing.assert_array_equal(jax_code.load_parity_mtx(path), H)
    with pytest.raises(KeyError):
        port_code.get_code("no_such_code")
