"""PyTorch port on the card: the CUDA min-sum, SPA, erasure and ADMM
kernels against their plain PyTorch versions, bit for bit (decisions and
iteration counts; ADMM's fractional x too), single-cap and with ``caps=``
snapshot planes; the LT peel kernel against the plain sparse engine and
the dense engine (results, resolved sets, recovered bits), its own edge
layout against ``edge_layout``, with its tables in shared and in device
memory, and no PyTorch sort, bincount or gather on its route; ADMMA's
train mode against the ADMM kernel; ADMMA's step kernels (the split
iteration K1-K3 of ``csrc/admm_step.cu`` bit for bit, the fused MLP
``csrc/mlp_fused.cu`` within 1e-5) against their plain versions.
Marked ``cuda`` and skipped without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoders_tpu_torch.channels import bec, biawgn, bsc  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.ops import (  # noqa: E402
    admm_kernel,
    bec_kernel,
    msa_kernel,
    spa_kernel,
)
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph, bp_tables  # noqa: E402


COMMITTED_CACHE = os.path.join(os.path.dirname(__file__), "..", "cache")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,snr", [("1200_3_6_ldpc", 1.5),
                                      ("1200_3_6_ldpc", 3.0),
                                      ("1200_rho_x5_rand_ldpc_1", 2.0)])
@pytest.mark.parametrize("msg_dtype", ["bfloat16", "float32"])
def test_kernel_bit_equal_plain(cuda, name, snr, msg_dtype):
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.zeros((1024, code.get_n()), dtype=torch.int32, device=cuda)
    llr = biawgn.llr(biawgn.send(x, snr, gen), snr)
    kw = dict(max_iter=10, check_init=False,
              msg_dtype=getattr(torch, msg_dtype))
    before = msa_kernel.msa_decode_cuda.launches
    xk, ik = msa_kernel.msa_decode(llr, t, **kw)
    assert msa_kernel.msa_decode_cuda.launches == before + 1
    xp, ip = msa_kernel.msa_decode_plain(llr, t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(xk, xp) and torch.equal(ik, ip)


@pytest.mark.cuda
def test_kernel_check_init_and_shapes(cuda):
    t = bp_tables(get_code("1200_3_6_ldpc").graph.to(cuda))
    kw = dict(max_iter=10, msg_dtype=torch.bfloat16)
    llr = torch.full((5, 1200), 4.0, device=cuda)
    x, it = msa_kernel.msa_decode_cuda(llr, t, check_init=True, **kw)
    assert int(x.sum()) == 0 and int(it.sum()) == 0
    x, it = msa_kernel.msa_decode_cuda(llr[:0], t, check_init=True, **kw)
    assert x.shape == (0, 1200) and it.shape == (0,)
    with pytest.raises(ValueError):
        msa_kernel.msa_decode_cuda(llr.double(), t, check_init=True, **kw)
    with pytest.raises(ValueError):
        msa_kernel.msa_decode_cuda(llr[:, :600], t, check_init=True, **kw)


def _llr(code, channel, param, batch, cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.zeros((batch, code.get_n()), dtype=torch.int32, device=cuda)
    mod = {"biawgn": biawgn, "bsc": bsc}[channel]
    return mod.llr(mod.send(x, param, gen), param)


@pytest.mark.cuda
@pytest.mark.parametrize("name,channel,param,check_init,max_iter", [
    ("1200_3_6_ldpc", "biawgn", 1.5, False, 10),
    ("1200_3_6_ldpc", "bsc", 0.05, True, 10),
    ("1200_rho_x5_rand_ldpc_3", "bsc", 0.05, True, 100),
    ("margulis", "biawgn", 2.25, False, 10),
])
@pytest.mark.parametrize("policy", ["reference", "saturate"])
@pytest.mark.parametrize("msg_dtype", ["bfloat16", "float32"])
def test_spa_kernel_bit_equal_plain(cuda, name, channel, param, check_init,
                                    max_iter, policy, msg_dtype):
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    llr = _llr(code, channel, param, 512, cuda, seed=11)
    kw = dict(max_iter=max_iter, check_init=check_init,
              msg_dtype=getattr(torch, msg_dtype), inf_policy=policy)
    before = spa_kernel.spa_decode_cuda.launches[policy]
    xk, ik = spa_kernel.spa_decode(llr, t, **kw)
    assert spa_kernel.spa_decode_cuda.launches[policy] == before + 1
    xp, ip = spa_kernel.spa_decode_plain(llr, t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(xk, xp) and torch.equal(ik, ip), (
        int((xk != xp).any(dim=1).sum()), int((ik != ip).sum()))


# Threads per word: one warp, counts that are no power of two, the most.
SPA_THREADS = [32, 96, 192, 256, 320, 448, 640, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("name,channel,param,check_init,max_iter,msg_dtype", [
    ("1200_3_6_ldpc", "biawgn", 2.0, False, 10, "bfloat16"),
    ("1200_3_6_ldpc", "bsc", 0.05, True, 10, "float32"),
    ("1200_rho_x5_rand_ldpc_3", "bsc", 0.05, True, 100, "float32"),
    ("margulis", "biawgn", 2.25, False, 10, "bfloat16"),
    ("7_4_hamming", "biawgn", 3.0, False, 10, "bfloat16"),
])
@pytest.mark.parametrize("policy", ["reference", "saturate"])
def test_spa_kernel_every_geometry(cuda, name, channel, param, check_init,
                                   max_iter, msg_dtype, policy):
    """The outputs do not depend on the threads per word: under each count
    the kernel equals the plain version bit for bit."""
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    llr = _llr(code, channel, param, 256, cuda, seed=12)
    kw = dict(max_iter=max_iter, check_init=check_init,
              msg_dtype=getattr(torch, msg_dtype), inf_policy=policy)
    xp, ip = spa_kernel.spa_decode_plain(llr, t, **kw)
    for threads in SPA_THREADS + [None]:              # None: the rule's
        xk, ik = spa_kernel.spa_decode_cuda(llr, t, threads=threads, **kw)
        torch.cuda.synchronize()
        assert torch.equal(xk, xp) and torch.equal(ik, ip), threads
    for threads in (0, 48, 2048):
        with pytest.raises(ValueError, match="threads per word"):
            spa_kernel.spa_decode_cuda(llr, t, threads=threads, **kw)


@pytest.mark.cuda
def test_spa_phi_table_equals_plain_phi(cuda):
    """The bf16 phi table that the kernel library fills on the card equals
    the plain phi on all its inputs, bit for bit, and is kept per device."""
    tab = spa_kernel.phi_table_cuda(cuda)
    assert tab is spa_kernel.phi_table_cuda(cuda)
    want = spa_kernel.phi_table_plain(cuda)
    got = tab
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), int(
        (got != want).sum())
    assert tab.shape == (spa_kernel.PHI_TAB_SIZE,)
    with pytest.raises(ValueError, match="CUDA"):
        spa_kernel.phi_table_cuda("cpu")


@pytest.mark.cuda
def test_spa_kernel_check_init_and_refusals(cuda):
    t = bp_tables(get_code("1200_3_6_ldpc").graph.to(cuda))
    kw = dict(max_iter=10, msg_dtype=torch.float32, inf_policy="reference")
    llr = torch.full((5, 1200), 4.0, device=cuda)
    x, it = spa_kernel.spa_decode_cuda(llr, t, check_init=True, **kw)
    assert int(x.sum()) == 0 and int(it.sum()) == 0
    x, it = spa_kernel.spa_decode_cuda(llr, t, check_init=False, **kw)
    assert int(x.sum()) == 0 and (it == 1).all()
    x, it = spa_kernel.spa_decode_cuda(llr[:0], t, check_init=True, **kw)
    assert x.shape == (0, 1200) and it.shape == (0,)
    for bad in (llr.double(), llr[:, :600], llr.cpu(), llr.t()):
        with pytest.raises(ValueError):
            spa_kernel.spa_decode_cuda(bad, t, check_init=True, **kw)
    with pytest.raises(ValueError):
        spa_kernel.spa_decode_cuda(llr, t, check_init=True, max_iter=10,
                                   msg_dtype=torch.float16,
                                   inf_policy="reference")
    with pytest.raises(ValueError):
        spa_kernel.spa_decode_cuda(llr, t, check_init=True, max_iter=10,
                                   msg_dtype=torch.float32,
                                   inf_policy="clip")
    # A check row wider than the kernel's register row is refused.
    H = np.zeros((2, 12), dtype=np.int8)
    H[0, :spa_kernel.MAX_CHK_DEG + 1] = 1
    H[1, 8:] = 1
    wide = bp_tables(TannerGraph.from_parity_mtx(H, device=cuda))
    with pytest.raises(ValueError, match="check degree"):
        spa_kernel.spa_decode_cuda(llr[:, :12].contiguous(), wide,
                                   check_init=True, **kw)


# (warps per word, words per CTA): few and many words of one warp per CTA,
# one word of 2, 4 and 8 warps per CTA; every graph below takes each.
BEC_GEOMETRIES = [(1, 1), (1, 8), (1, 15), (2, 1), (4, 1), (8, 1)]
MSA_GEOMETRIES = [(1, 1), (1, 5), (2, 1), (4, 1), (8, 1)]
BP_INPUTS = [("1200_3_6_ldpc", 0.4, 2.0), ("1200_rho_x5_rand_ldpc_3", 0.4, 2.0),
             ("margulis", 0.375, 2.25), ("7_4_hamming", 0.3, 3.0)]


def _erased(code, p, batch, cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.zeros((batch, code.get_n()), dtype=torch.int32, device=cuda)
    return bec.send(x, p, gen)


@pytest.mark.cuda
@pytest.mark.parametrize("name,p,max_iter", [
    ("1200_3_6_ldpc", 0.45, 10),
    ("1200_3_6_ldpc", 0.375, 100),
    ("1200_3_6_ldpc", 0.3, 2000),
    ("1200_rho_x5_rand_ldpc_3", 0.4, 100),
    ("margulis", 0.375, 10),
    ("7_4_hamming", 0.3, 10),
])
def test_bec_kernel_bit_equal_plain(cuda, name, p, max_iter):
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    y = _erased(code, p, 1024, cuda, seed=5)
    y[0] = 0                                       # an erasure-free word
    before = bec_kernel.bec_spa_decode_cuda.launches
    xk, ik = bec_kernel.bec_spa_decode(y, t, max_iter=max_iter)
    assert bec_kernel.bec_spa_decode_cuda.launches == before + 1
    xp, ip = bec_kernel.bec_spa_decode_plain(y, t, max_iter=max_iter)
    torch.cuda.synchronize()
    assert torch.equal(xk, xp) and torch.equal(ik, ip), (
        int((xk != xp).any(dim=1).sum()), int((ik != ip).sum()))
    assert int(ik[0]) == 0 and int(ik.max()) > 1


@pytest.mark.cuda
def test_bec_kernel_random_symbols_and_refusals(cuda):
    """Uniformly random symbols are no codeword's image: checks disagree
    and marginals return to 0, which the literal stopping test must
    follow."""
    code = get_code("1200_3_6_ldpc")
    t = bp_tables(code.graph.to(cuda))
    gen = torch.Generator(device=cuda).manual_seed(9)
    y = torch.randint(0, 3, (512, 1200), generator=gen, device=cuda,
                      dtype=torch.int32)
    xp, ip = bec_kernel.bec_spa_decode_plain(y, t, max_iter=50)
    for geo in BEC_GEOMETRIES + [None]:               # None: the rule's
        xk, ik = bec_kernel.bec_spa_decode_cuda(y, t, max_iter=50,
                                                geometry=geo)
        torch.cuda.synchronize()
        assert torch.equal(xk, xp) and torch.equal(ik, ip), geo
    x, it = bec_kernel.bec_spa_decode_cuda(y[:0], t, max_iter=10)
    assert x.shape == (0, 1200) and it.shape == (0,)
    for bad in (y.float(), y[:, :600], y.cpu(), y.t()):
        with pytest.raises(ValueError):
            bec_kernel.bec_spa_decode_cuda(bad, t, max_iter=10)
    with pytest.raises(ValueError, match="caps"):
        bec_kernel.bec_spa_decode_cuda(y, t, max_iter=10, caps=(3, 2, 10))
    with pytest.raises(ValueError, match="caps"):
        bec_kernel.bec_spa_decode_cuda(y, t, max_iter=20,
                                       caps=tuple(range(1, 21)))


CAPS = (1, 2, 3, 6, 10, 40, 100)


def _assert_planes(cuda_fn, plain_fn, inp, t, kw):
    """caps= kernel == plain caps= version, and each plane == the
    single-cap kernel at that cap, bit for bit."""
    xs, it = cuda_fn(inp, t, max_iter=CAPS[-1], caps=CAPS, **kw)
    xp, ip = plain_fn(inp, t, max_iter=CAPS[-1], caps=CAPS, **kw)
    torch.cuda.synchronize()
    assert xs.shape == (len(CAPS),) + tuple(inp.shape)
    assert torch.equal(xs, xp) and torch.equal(it, ip)
    for k, cap in enumerate(CAPS):
        x1, i1 = cuda_fn(inp, t, max_iter=cap, **kw)
        assert torch.equal(xs[k], x1), cap
        assert torch.equal(it.clamp(max=cap), i1), cap
    assert int(it.max()) > CAPS[2]


@pytest.mark.cuda
@pytest.mark.parametrize("channel,param,check_init,msg_dtype", [
    ("biawgn", 2.0, False, "bfloat16"), ("bsc", 0.05, True, "float32")])
def test_msa_caps_planes(cuda, channel, param, check_init, msg_dtype):
    code = get_code("1200_3_6_ldpc")
    t = bp_tables(code.graph.to(cuda))
    llr = _llr(code, channel, param, 512, cuda, seed=13)
    before = msa_kernel.msa_decode_cuda.launches_caps
    _assert_planes(msa_kernel.msa_decode_cuda, msa_kernel.msa_decode_plain,
                   llr, t, dict(check_init=check_init,
                                msg_dtype=getattr(torch, msg_dtype)))
    assert msa_kernel.msa_decode_cuda.launches_caps == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("channel,param,check_init,msg_dtype", [
    ("biawgn", 2.0, False, "bfloat16"), ("bsc", 0.07, True, "float32")])
@pytest.mark.parametrize("policy", ["reference", "saturate"])
def test_spa_caps_planes(cuda, channel, param, check_init, msg_dtype, policy):
    code = get_code("1200_3_6_ldpc")
    t = bp_tables(code.graph.to(cuda))
    llr = _llr(code, channel, param, 512, cuda, seed=14)
    before = spa_kernel.spa_decode_cuda.launches_caps[policy]
    _assert_planes(spa_kernel.spa_decode_cuda, spa_kernel.spa_decode_plain,
                   llr, t, dict(check_init=check_init, inf_policy=policy,
                                msg_dtype=getattr(torch, msg_dtype)))
    assert spa_kernel.spa_decode_cuda.launches_caps[policy] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["1200_3_6_ldpc", "1200_rho_x5_rand_ldpc_3"])
def test_bec_caps_planes(cuda, name):
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    y = _erased(code, 0.4, 512, cuda, seed=15)
    before = bec_kernel.bec_spa_decode_cuda.launches_caps
    _assert_planes(bec_kernel.bec_spa_decode_cuda,
                   bec_kernel.bec_spa_decode_plain, y, t, {})
    assert bec_kernel.bec_spa_decode_cuda.launches_caps == before + 1


def _admm_llr(code, channel, param, batch, cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.ones((batch, code.get_n()), dtype=torch.int32, device=cuda)
    mod = {"biawgn": biawgn, "bsc": bsc, "bec": bec}[channel]
    return mod.llr(mod.send(x, param, gen), param)


ADMM_CASES = [
    ("1200_3_6_ldpc", "biawgn", 2.0, 50, 512),
    ("1200_3_6_ldpc", "biawgn", 3.0, 50, 512),
    ("1200_3_6_ldpc", "bsc", 0.05, 50, 512),
    ("1200_3_6_ldpc", "bec", 0.35, 50, 512),          # +-1e8 LLRs
    ("7_4_hamming", "bsc", 0.1, 50, 1024),            # var degrees 1..3
    ("7_4_hamming", "biawgn", 3.0, 2000, 1024),
    ("1200_rho_x5_rand_ldpc_3", "biawgn", 2.0, 50, 256),  # padded slots
    ("margulis", "biawgn", 2.0, 100, 128),
    ("margulis", "bsc", 0.07, 1000, 16),              # long tails
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,channel,param,max_iter,batch", ADMM_CASES)
def test_admm_kernel_bit_equal_plain(cuda, name, channel, param, max_iter,
                                     batch):
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    llr = _admm_llr(code, channel, param, batch, cuda, seed=21)
    kw = dict(mu=3.0, eps=1e-5, max_iter=max_iter, n_edge=code.graph.n_edge)
    before = admm_kernel.admm_decode_cuda.launches
    xk, ik, fk = admm_kernel.admm_decode(llr, t, **kw)
    assert admm_kernel.admm_decode_cuda.launches == before + 1
    xp, ip, fp = admm_kernel.admm_decode_plain(llr, t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip), (int((ik != ip).sum()), batch)
    assert torch.equal(xk, xp) and torch.equal(fk, fp), (
        int((xk != xp).any(dim=1).sum()), float((fk - fp).abs().max()))
    assert int(ik.min()) < max_iter or name == "margulis"


# Threads per word: few and many warps, counts that are no power of two.
ADMM_THREADS = [32, 96, 256, 320, 512, 704, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("name,channel,param,max_iter,batch", [
    ADMM_CASES[0], ADMM_CASES[3], ADMM_CASES[4], ADMM_CASES[6], ADMM_CASES[7],
    ("margulis", "bsc", 0.07, 8000, 16),              # converge mode
])
def test_admm_kernel_every_geometry(cuda, name, channel, param, max_iter,
                                    batch):
    """The outputs do not depend on the launch geometry: under each one
    the kernel equals the plain version bit for bit."""
    code = get_code(name)
    g = code.graph
    t = bp_tables(g.to(cuda))
    llr = _admm_llr(code, channel, param, batch, cuda, seed=22)
    kw = dict(mu=3.0, eps=1e-5, max_iter=max_iter, n_edge=g.n_edge)
    want = admm_kernel.admm_decode_plain(llr, t, **kw)
    for threads in ADMM_THREADS + [None]:             # None: the rule's
        before = admm_kernel.admm_decode_cuda.launches
        got = admm_kernel.admm_decode_cuda(llr, t, threads=threads, **kw)
        torch.cuda.synchronize()
        assert admm_kernel.admm_decode_cuda.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b), threads
    assert int(want[1].max()) > 30 or name == "7_4_hamming"


@pytest.mark.cuda
def test_admm_kernel_shapes_and_refusals(cuda):
    code = get_code("1200_3_6_ldpc")
    t = bp_tables(code.graph.to(cuda))
    kw = dict(mu=3.0, eps=1e-5, max_iter=50, n_edge=code.graph.n_edge)
    llr = torch.full((5, 1200), -4.0, device=cuda)
    x, it, xf = admm_kernel.admm_decode_cuda(llr, t, **kw)
    assert int(x.sum()) == 5 * 1200 and (it < 50).all()
    assert xf.dtype == torch.float32 and float(xf.min()) == 1.0
    x, it, xf = admm_kernel.admm_decode_cuda(llr[:0], t, **kw)
    assert x.shape == (0, 1200) and it.shape == (0,) and xf.shape == (0, 1200)
    for bad in (llr.double(), llr[:, :600], llr.cpu(), llr.t()):
        with pytest.raises(ValueError):
            admm_kernel.admm_decode_cuda(bad, t, **kw)
    H = np.zeros((2, 12), dtype=np.int8)
    H[0, :admm_kernel.MAX_CHK_DEG + 1] = 1
    H[1, 8:] = 1
    wide = bp_tables(TannerGraph.from_parity_mtx(H, device=cuda))
    with pytest.raises(ValueError, match="check degree"):
        admm_kernel.admm_decode_cuda(llr[:, :12].contiguous(), wide, **kw)
    # A geometry the kernel cannot take raises: there is no other route.
    for threads in (0, 48, 2048):
        with pytest.raises(ValueError):
            admm_kernel.admm_decode_cuda(llr, t, threads=threads, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name,p,snr", BP_INPUTS)
@pytest.mark.parametrize("caps", [None, CAPS])
def test_bec_kernel_every_geometry(cuda, name, p, snr, caps):
    """The erasure kernel's outputs do not depend on the warps per word or
    the words per CTA: under each geometry it equals the plain version bit
    for bit, single-cap and with caps=."""
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    y = _erased(code, p, 512, cuda, seed=16)
    xp, ip = bec_kernel.bec_spa_decode_plain(y, t, max_iter=100, caps=caps)
    for geo in BEC_GEOMETRIES + [None]:               # None: the rule's
        xk, ik = bec_kernel.bec_spa_decode_cuda(y, t, max_iter=100, caps=caps,
                                                geometry=geo)
        torch.cuda.synchronize()
        assert torch.equal(xk, xp) and torch.equal(ik, ip), geo


@pytest.mark.cuda
@pytest.mark.parametrize("name,p,snr", BP_INPUTS)
@pytest.mark.parametrize("caps", [None, CAPS])
@pytest.mark.parametrize("msg_dtype", ["bfloat16", "float32"])
def test_msa_kernel_every_geometry(cuda, name, p, snr, caps, msg_dtype):
    """The min-sum kernel's outputs do not depend on the warps per word or
    the words per CTA: under each geometry it equals the plain version bit
    for bit, single-cap and with caps=."""
    code = get_code(name)
    t = bp_tables(code.graph.to(cuda))
    llr = _llr(code, "biawgn", snr, 512, cuda, seed=17)
    kw = dict(max_iter=CAPS[-1] if caps else 20, check_init=False,
              msg_dtype=getattr(torch, msg_dtype), caps=caps)
    xp, ip = msa_kernel.msa_decode_plain(llr, t, **kw)
    for geo in MSA_GEOMETRIES + [None]:               # None: the rule's
        xk, ik = msa_kernel.msa_decode_cuda(llr, t, geometry=geo, **kw)
        torch.cuda.synchronize()
        assert torch.equal(xk, xp) and torch.equal(ik, ip), geo


@pytest.mark.cuda
def test_bp_kernel_geometry_refusals(cuda):
    """A geometry the kernel or the card cannot take raises at the wrapper,
    and the launch functions refuse it on their own."""
    code = get_code("1200_3_6_ldpc")
    t = bp_tables(code.graph.to(cuda))
    y = _erased(code, 0.4, 64, cuda, seed=18)
    llr = _llr(code, "biawgn", 2.0, 64, cuda, seed=18)
    kw = dict(max_iter=10, check_init=False, msg_dtype=torch.bfloat16)
    for geo in ((3, 1), (2, 16), (1, 33), (8, 8), (1, 0)):
        with pytest.raises(ValueError):
            bec_kernel.bec_spa_decode_cuda(y, t, max_iter=10, geometry=geo)
        with pytest.raises(ValueError):
            msa_kernel.msa_decode_cuda(llr, t, geometry=geo, **kw)
    mar = bp_tables(get_code("margulis").graph.to(cuda))
    llr_mar = _llr(get_code("margulis"), "biawgn", 2.0, 64, cuda, seed=18)
    with pytest.raises(ValueError, match="shared memory"):
        msa_kernel.msa_decode_cuda(llr_mar, mar, max_iter=10,
                                   check_init=False, msg_dtype=torch.float32,
                                   geometry=(1, 7))
    bec_lib = bec_kernel._kernel_library()
    msa_lib = msa_kernel._kernel_library()
    assert bec_lib.bec_decode_occupancy(600, 1200, 6, 3, 1, 8) > 0
    assert msa_lib.msa_decode_occupancy(600, 1200, 6, 3, 1, 1, 8) > 0
    for g, w in ((3, 1), (2, 16), (1, 33), (8, 8)):
        assert bec_lib.bec_decode_occupancy(600, 1200, 6, 3, g, w) < 0
        assert msa_lib.msa_decode_occupancy(600, 1200, 6, 3, 1, g, w) < 0
    assert msa_lib.msa_decode_occupancy(1320, 2640, 6, 3, 0, 1, 7) < 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant,policy,channel,param", [
    ("MSA", "saturate", "biawgn", 2.0), ("SPA", "reference", "bsc", 0.05),
    ("SPA", "saturate", "biawgn", 2.0), ("BEC", None, "bec", 0.4)])
def test_ensemble_decoders_on_members_with_empty_columns(cuda, variant,
                                                         policy, channel,
                                                         param):
    """The joint decoders over IREG members 4 and 5 (two and three
    variables of degree 0): one kernel launch per member, each member's
    outputs == its own plain version's."""
    from ldpc_decoders_tpu_torch.decoders.bp_ensemble import (
        EnsembleBECSPADecoder,
        EnsembleBPDecoder,
    )
    codes = [get_code(f"1200_rho_x5_rand_ldpc_{i}") for i in (4, 5)]
    graphs = [c.graph for c in codes]
    if variant == "BEC":
        inp = torch.stack([_erased(c, param, 256, cuda, seed=i)
                           for i, c in enumerate(codes)])
        dec = EnsembleBECSPADecoder(graphs, max_iter=100, device=cuda)
        counter, key = bec_kernel.bec_spa_decode_cuda, None
    else:
        inp = torch.stack([_llr(c, channel, param, 256, cuda, seed=i)
                           for i, c in enumerate(codes)])
        dec = EnsembleBPDecoder(graphs, variant, max_iter=100,
                                msg_dtype=torch.float32,
                                check_init=channel != "biawgn",
                                inf_policy=policy, device=cuda)
        counter = (msa_kernel.msa_decode_cuda if variant == "MSA"
                   else spa_kernel.spa_decode_cuda)
        key = policy if variant == "SPA" else None
    count = (lambda: counter.launches[key]) if key else \
        (lambda: counter.launches)
    before = count()
    xs, its = dec.decode(inp)
    assert count() == before + 2
    for g, member in enumerate(dec.members):
        t = member.tables
        if variant == "BEC":
            want = bec_kernel.bec_spa_decode_plain(inp[g], t, max_iter=100)
        elif variant == "MSA":
            want = msa_kernel.msa_decode_plain(
                inp[g], t, max_iter=100, check_init=False,
                msg_dtype=torch.float32)
        else:
            want = spa_kernel.spa_decode_plain(
                inp[g], t, max_iter=100, check_init=channel != "biawgn",
                msg_dtype=torch.float32, inf_policy=policy)
        torch.cuda.synchronize()
        assert torch.equal(xs[g], want[0]) and torch.equal(its[g], want[1])


# -- LT peeling: csrc/lt_peel.cu against the plain sparse engine ------------

LT_CASES = [(0, 60, 120, 0.1, 24), (2, 40, 46, 0.1, 24),
            (3, 200, 260, 0.03, 16), (5, 10000, 12000, 0.03, 4)]


def _lt_tables(k, n, c, seed, batch, device):
    from ldpc_decoders_tpu_torch.fountain.lt import LTSimulator

    sim = LTSimulator(k, n, c, 0.5, device=device)
    return sim, sim.sample_batch(np.random.default_rng(seed), batch)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,n,c,batch", LT_CASES)
def test_lt_kernel_bit_equal_plain(cuda, seed, k, n, c, batch):
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    _, t = _lt_tables(k, n, c, seed, batch, cuda)
    args = [t[key].to(cuda) for key in ("edge_sym", "edge_var", "msg")]
    before = lt_kernel.lt_peel_cuda.launches
    rk, ek, vk, _ = lt_kernel.lt_peel(*args, n)
    assert lt_kernel.lt_peel_cuda.launches == before + 1
    rp, ep, vp, _ = lt_kernel.lt_peel_plain(*args, n)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp) and torch.equal(vk, vp)
    assert torch.equal(ek[vk], ep[vp])
    if n == 46:
        assert bool((rk == n).any())


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,n,c,batch", LT_CASES)
def test_lt_kernel_layout_equals_edge_layout(cuda, seed, k, n, c, batch):
    """The kernel's own tables (its counting sort) against ``edge_layout``:
    offsets equal, each variable's symbols the same multiset."""
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    _, t = _lt_tables(k, n, c, seed, batch, cuda)
    args = [t[key].to(cuda) for key in ("edge_sym", "edge_var", "msg")]
    before = lt_kernel.lt_layout_cuda.launches
    tables = lt_kernel.lt_layout_cuda(*args, n)
    assert lt_kernel.lt_layout_cuda.launches == before + 1
    assert lt_kernel.layout_matches(tables, args[0], args[1], n)


@pytest.mark.cuda
def test_lt_kernel_tables_in_device_memory(cuda):
    """At the largest n the first form of the kernel took at k=10000, the
    symbol words and variable offsets do not fit in shared memory: the
    kernel keeps them in device memory and still equals the plain
    version, its tables ``edge_layout``'s."""
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    k = 10000
    n = (lt_kernel.SMEM_PER_CTA - 8 * ((k + 31) // 32)) // 8
    _, t = _lt_tables(k, n, 0.03, 6, 2, cuda)
    args = [t[key].to(cuda) for key in ("edge_sym", "edge_var", "msg")]
    assert not lt_kernel.kernel_plan(*args, n)
    rk, ek, vk, _ = lt_kernel.lt_peel_cuda(*args, n)
    rp, ep, vp, _ = lt_kernel.lt_peel_plain(*args, n)
    torch.cuda.synchronize()
    assert torch.equal(rk, rp) and torch.equal(vk, vp)
    assert torch.equal(ek[vk], ep[vp])
    assert lt_kernel.layout_matches(lt_kernel.lt_layout_cuda(*args, n),
                                    args[0], args[1], n)


@pytest.mark.cuda
def test_lt_card_route_builds_its_layout_in_cuda(cuda, monkeypatch):
    """The simulator's card route calls no PyTorch sort, bincount or
    gather: the edge layout is the kernel's own."""
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    sim, t = _lt_tables(200, 260, 0.03, 3, 16, cuda)
    want = lt_kernel.lt_peel_plain(
        *[t[key].to(cuda) for key in ("edge_sym", "edge_var", "msg")], 260)

    def refuse(*args, **kwargs):
        raise AssertionError("a PyTorch sort, bincount or gather ran")

    for owner, name in ((torch, "sort"), (torch, "bincount"),
                        (torch, "gather"), (torch.Tensor, "sort"),
                        (torch.Tensor, "gather")):
        monkeypatch.setattr(owner, name, refuse)
    rk, ek, vk = sim.simulate(t)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert torch.equal(rk, want[0]) and torch.equal(vk, want[2])
    assert torch.equal(ek[vk], want[1][want[2]])


@pytest.mark.cuda
def test_lt_simulator_on_card_launches_kernel_and_dense_agrees(cuda):
    from ldpc_decoders_tpu_torch.fountain.lt import LTSimulator
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    sim, t = _lt_tables(200, 260, 0.1, 7, 16, cuda)
    assert sim.engine == "sparse" and t["msg"].is_pinned()
    before = lt_kernel.lt_peel_cuda.launches
    rk, ek, vk = sim.simulate(t)
    assert lt_kernel.lt_peel_cuda.launches == before + 1
    dense = LTSimulator(200, 260, 0.1, 0.5, engine="dense", device=cuda)
    rd, ed, vd = dense.simulate(t)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.equal(rk, rd) and torch.equal(vk, vd)
    assert torch.equal(ek[vk], ed[vd])
    assert torch.equal(ek[vk].cpu(), t["msg"][vk.cpu()])


@pytest.mark.cuda
def test_lt_kernel_has_no_fallback(cuda, monkeypatch):
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    _, t = _lt_tables(60, 120, 0.1, 1, 4, cuda)
    args = [t[key].to(cuda) for key in ("edge_sym", "edge_var", "msg")]

    def no_library(name):
        raise RuntimeError(f"cannot build {name}")

    monkeypatch.setattr(lt_kernel, "load_library", no_library)
    with pytest.raises(RuntimeError, match="cannot build"):
        lt_kernel.lt_peel(*args, 120)


@pytest.mark.cuda
def test_lt_kernel_refusals(cuda):
    from ldpc_decoders_tpu_torch.fountain.lt import LTSimulator
    from ldpc_decoders_tpu_torch.ops import lt_kernel

    z = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16-bit"):
        lt_kernel.lt_peel_cuda(z, z, z, 70000)
    with pytest.raises(ValueError, match="shared memory"):
        lt_kernel.lt_peel_cuda(z, z, torch.zeros((1, 2_000_000),
                                                 dtype=torch.int32,
                                                 device=cuda), 20000)
    r, e, v, _ = lt_kernel.lt_peel_cuda(z[:0], z[:0], z[:0], 8)
    assert r.shape == (0,) and e.shape == (0, 8)
    # 200 sims' G would take 96 GB: refused before anything is built.
    big = LTSimulator(10000, 12000, 0.03, 0.5, engine="dense", device=cuda)
    pads = {"edge_sym": torch.full((200, 8), 12000, dtype=torch.int32),
            "edge_var": torch.full((200, 8), 10000, dtype=torch.int32),
            "msg": torch.zeros((200, 10000), dtype=torch.int32)}
    with pytest.raises(MemoryError):
        big.simulate(pads)


@pytest.mark.cuda
@pytest.mark.parametrize("name,channel,param", [("7_4_hamming", "bsc", 0.1),
                                                ("1200_3_6_ldpc", "biawgn",
                                                 2.5)])
def test_admma_train_mode_equals_admm_kernel(cuda, tmp_path, name, channel,
                                             param):
    """ADMMA's train mode decodes with the exact projection through the
    split loop on the card (K1, K2, K3, and K4's training pass for the Adam
    step): it must equal the whole-loop ADMM kernel bit for bit, launch each
    of those kernels once per loop iteration, and not the ADMM kernel."""
    from ldpc_decoders_tpu_torch.decoders.admma import ADMMADecoder
    from ldpc_decoders_tpu_torch.utils.math import pseudo_to_cw_tensor

    code = get_code(name)
    mod = {"bsc": bsc, "biawgn": biawgn}[channel]
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = torch.ones((512, code.get_n()), dtype=torch.int32, device=cuda)
    llr = mod.llr(mod.send(x, param, gen), param)
    kw = dict(mu=3.0, eps=1e-5, max_iter=50)
    t = bp_tables(code.graph.to(cuda))
    want = admm_kernel.admm_decode_cuda(llr, t, n_edge=code.graph.n_edge,
                                        **kw)
    before = admm_kernel.admm_decode_cuda.launches
    counters = _step_counters()
    for pseudo in (False, True):
        start = [c.launches for c in counters]
        dec = ADMMADecoder(code.graph, train=True, layers=[32],
                           allow_pseudo=pseudo, cache_dir=str(tmp_path),
                           device=cuda, **kw)
        w0 = dec.mlp.w0.detach().clone()
        x_hat, iters = dec.decode(llr)
        torch.cuda.synchronize()
        assert torch.equal(iters, want[1])
        assert torch.equal(x_hat, pseudo_to_cw_tensor(want[2], True)
                           if pseudo else want[0])
        assert not torch.equal(w0, dec.mlp.w0)
        loops = int(iters.max()) + (int(iters.max()) < 50)
        assert [c.launches - s0 for c, s0 in zip(counters, start)] == \
            [loops, loops, loops, 0, loops]
    assert admm_kernel.admm_decode_cuda.launches == before


def _step_counters():
    """K1, K2, K3, K4 forward, K4 train."""
    from ldpc_decoders_tpu_torch.ops import admm_step, mlp_kernel

    return [admm_step.admm_iter_pre_cuda, admm_step.project_rows_cuda,
            admm_step.admm_iter_post_cuda, mlp_kernel.mlp_forward_cuda,
            mlp_kernel.mlp_train_cuda]


def _step_state(name, batch, cuda, seed):
    """Seeded ADMM state on the card: (t, step tables, z, lam, g)."""
    from ldpc_decoders_tpu_torch.ops import admm_step

    t = bp_tables(get_code(name).graph.to(cuda))
    C, Dc = t.chk_var.shape
    V = t.var_slot.shape[0]
    rng = np.random.default_rng(seed)
    cm = t.cmask.cpu().numpy()

    def dev(a):
        return torch.as_tensor(a.astype(np.float32), device=cuda)

    z = dev(np.where(cm, rng.random((batch, C, Dc)), 0.0))
    lam = dev(np.where(cm, rng.normal(0.0, 0.3, (batch, C, Dc)), 0.0))
    g = dev(rng.normal(0.0, 2.0, (batch, V)))
    return t, admm_step.step_tables(t), z, lam, g


STEP_CASES = [(name, batch) for name in ("1200_3_6_ldpc", "7_4_hamming",
                                         "1200_rho_x5_rand_ldpc_3")
              for batch in (1, 7, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch", STEP_CASES)
def test_admm_step_kernels_bit_equal_plain(cuda, name, batch):
    """K1, K2 and K3 each equal their plain version bit for bit, frozen and
    converging words included (the irregular code has padded check
    slots)."""
    from ldpc_decoders_tpu_torch.ops import admm_step
    from ldpc_decoders_tpu_torch.ops.admm_kernel import (
        _inv_mu,
        _threshold,
        admm_iter_post_plain,
        admm_iter_pre_plain,
    )
    from ldpc_decoders_tpu_torch.ops.projection import project_parity_polytope

    t, st, z, lam, g = _step_state(name, batch, cuda, seed=batch)
    inv_mu = _inv_mu(3.0)
    n_edge = int(t.cmask.sum())
    counters = _step_counters()
    start = [c.launches for c in counters]
    # K1
    x_new, x_e, v = admm_iter_pre_plain(z, lam, g, t, torch.tensor(
        inv_mu, device=cuda))
    xk, vk = admm_step.admm_iter_pre_cuda(z, lam, g, st, inv_mu)
    torch.cuda.synchronize()
    assert torch.equal(xk, x_new) and torch.equal(vk, v)
    # K2, with the mask and without it
    z_new = project_parity_polytope(v, mask=t.cmask)
    assert torch.equal(admm_step.project_rows_cuda(v, t.cmask), z_new)
    assert torch.equal(admm_step.project_rows_cuda(v),
                       project_parity_polytope(v))
    # K3: every third word at a fixed point (it converges now), every
    # fourth already frozen.
    words = torch.arange(batch, device=cuda)
    fixed = (words % 3 == 0)[:, None, None]
    z_new = torch.where(fixed, x_e, z_new)
    z = torch.where(fixed, x_e, z)
    done = words % 4 == 1
    updates = (words * 7 % 13).to(torch.int32)
    state = (torch.rand(x_new.shape, device=cuda), z, lam, updates, done)
    mu_t = torch.tensor(3.0, device=cuda)
    thresh = _threshold(1e-5, n_edge)
    want = admm_iter_post_plain(*state[:3], x_new, x_e, z_new, *state[3:],
                                t, mu_t, torch.tensor(thresh, device=cuda))
    got = admm_step.admm_iter_post_cuda(*[a.clone() for a in state[:3]],
                                        x_new, None, z_new,
                                        *[a.clone() for a in state[3:]], st,
                                        3.0, thresh)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(want[4][0])            # word 0 converged now
    assert [c.launches - s0 for c, s0 in zip(counters, start)] == \
        [1, 2, 1, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("Dc", range(1, 9))
def test_admm_iter_post_every_width_bit_equal_plain(cuda, Dc):
    """K3 at every compiled row width, on a synthetic graph of C = 1001
    rows (several units a word; C*Dc odd, or 2 mod 4, or a multiple of 4, so
    words start off and on 16-byte boundaries) with random variables and
    about a tenth of the slots padded: B = 2048 words (more than one wave
    of CTAs), about 60% of them frozen and a fifth of the running ones at a
    fixed point. Bit-equal to the plain version in x, z, lam, updates,
    done and the count of words left, under the wrapper's plan (four units
    of 256 rows a word) and units of 512, 64 and 32 rows."""
    from ldpc_decoders_tpu_torch.ops import admm_step
    from ldpc_decoders_tpu_torch.ops.admm_kernel import (
        _threshold,
        admm_iter_post_plain,
    )

    B, C, V = 2048, 1001, 700
    rng = np.random.default_rng(Dc)
    chk = rng.integers(0, V, (C, Dc))
    chk[rng.random((C, Dc)) < 0.1] = -1
    chk_var = torch.as_tensor(chk, dtype=torch.int32, device=cuda)
    cmask = chk_var >= 0
    st = admm_step.StepTables(chk_var, torch.zeros((V, 1), dtype=torch.int32,
                                                   device=cuda))

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda)

    x_new = dev(rng.random((B, V)))
    x_e = torch.where(cmask, x_new[:, chk_var.clamp(min=0).long()], 0.0)
    fixed = torch.as_tensor(rng.random(B) < 0.2, device=cuda)[:, None, None]
    z_new = torch.where(fixed, x_e, torch.where(
        cmask, dev(rng.random((B, C, Dc))), 0.0))
    state = (dev(rng.random((B, V))),
             torch.where(fixed, x_e, torch.where(
                 cmask, dev(rng.random((B, C, Dc))), 0.0)),
             torch.where(cmask, dev(rng.normal(0, 0.3, (B, C, Dc))), 0.0),
             torch.as_tensor(rng.integers(0, 50, B), dtype=torch.int32,
                             device=cuda),
             torch.as_tensor(rng.random(B) < 0.6, device=cuda))
    thresh = _threshold(1e-5, int(cmask.sum()))
    want = admm_iter_post_plain(*state[:3], x_new, x_e, z_new, *state[3:],
                                None, torch.tensor(3.0, device=cuda),
                                torch.tensor(thresh, device=cuda))
    assert 0 < int((want[4] & ~state[4]).sum())      # some converge now
    plans = [None] + [admm_step.post_plan(C, Dc, max_rows=r)
                      for r in (992, 64, 32)]
    for plan in plans:
        got = admm_step.admm_iter_post_cuda(
            *[a.clone() for a in state[:3]], x_new, None, z_new,
            *[a.clone() for a in state[3:]], st, 3.0, thresh, plan=plan)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), plan


def off_relu_ties(params, x, rel=2.0 ** -17):
    """Which rows of x keep every hidden pre-activation z of the MLP
    farther than ``rel`` times its terms' magnitude (the sum of |a w| and
    |b|) from 0, in float64. Nearer, the relu's decision hangs on the last
    bits of the arithmetic (float32's own included), and one decided the
    other way moves a gradient summed over 100,003 rows by ~1e-5 relative
    (tests/test_torch_admma.py::
    test_relu_ties_decide_gradients_over_many_rows)."""
    a = x.double()
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for w, b in zip(params[0:-2:2], params[1:-2:2]):
        w, b = w.detach().double(), b.detach().double()
        z = a @ w + b
        keep &= (z.abs() > rel * (a.abs() @ w.abs() + b.abs())).all(1)
        a = torch.relu(z)
    return keep


def _mlp_rows(dim, layers, rows, cuda, seed):
    """The MLP of ``mlp_init(seed)``, ``rows`` rows drawn from N(0.5, 0.8)
    with numpy's seed, passing over rows at a relu tie (``off_relu_ties``),
    and their exact projection as the target."""
    from ldpc_decoders_tpu_torch.decoders.admma import mlp_init
    from ldpc_decoders_tpu_torch.ops.admm_step import project_rows

    params = list(mlp_init(dim, layers, seed, device=cuda).parameters())
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0.5, 0.8, (rows + rows // 8 + 64, dim))
                        .astype(np.float32), device=cuda)
    x = x[off_relu_ties(params, x)][:rows].contiguous()
    assert x.shape[0] == rows
    return params, x, project_rows(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,layers,rows,train", [
    (6, [100, 100], 100_003, True), (4, [64, 64], 100_003, True),
    (6, [32], 100_003, True), (5, [12, 40], 100_003, True),
    (6, [100, 100], 1, True), (6, [100, 100], 15, True),
    (6, [100, 100], 17, True), (6, [147, 147], 100_003, True),
    (6, [152, 152], 100_003, True), (6, [158, 158], 100_003, True),
    (6, [107, 107, 107], 100_003, True), (6, [213, 213], 100_003, False),
    (6, [224, 224], 100_003, False), (6, [1200], 100_003, False)])
def test_mlp_kernel_within_tolerance_of_plain(cuda, dim, layers, rows, train):
    """K4 against the plain MLP on the card (TF32 off): the forward within
    1e-5 abs and the training loss within 1e-5 relative of the plain MLP;
    every gradient within 1e-5 relative (the norm of the difference over
    the reference's norm) of the plain MLP evaluated in float64 from the
    same float32 parameters and rows; and the same bits on a second run.
    The gradients' reference is float64, and the rows pass over relu ties
    (``_mlp_rows``): at a tie the float32 plain MLP and the kernel may each
    decide the relu either way, and on the first case the float32 plain MLP
    misses the bar against float64 by one such decision, so a float32
    reference or tied rows would measure which way the last bits fell, not
    the kernel's accuracy. Nets up to the widest
    the kernel takes: the widest of the FFMA form before it ([6, 213, 213,
    6] forward only, [6, 147, 147, 6] trains), the widest at 16 rows a tile
    ([6, 152, 152, 6]), and nets that fit only the 8-row tile, whose row
    strides carry no padding ([6, 224, 224, 6] and [6, 1200, 6] forward,
    [6, 158, 158, 6] and [6, 107, 107, 107, 6] train); and row counts that
    leave a ragged tile, one row, or fewer rows than a 16-row block."""
    from ldpc_decoders_tpu_torch.ops import mlp_kernel

    assert not torch.backends.cuda.matmul.allow_tf32
    params, x, target = _mlp_rows(dim, layers, rows, cuda, seed=dim)
    out = mlp_kernel.mlp_forward_cuda(params, x)
    want = mlp_kernel.mlp_forward_plain(params, x).detach()
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= 1e-5
    assert torch.equal(out, mlp_kernel.mlp_forward_cuda(params, x))
    if not train:
        return
    loss, grads = mlp_kernel.mlp_train_cuda(params, x, target)
    loss_p, _ = mlp_kernel.mlp_train_plain(params, x, target)
    _, grads_64 = mlp_kernel.mlp_train_plain(
        [p.detach().double().requires_grad_(True) for p in params],
        x.double(), target.double())
    torch.cuda.synchronize()
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * float(loss_p)
    for g, w in zip(grads, grads_64):
        assert g.shape == w.shape
        assert float((g.double() - w).norm() / w.norm()) < 1e-5
    loss2, grads2 = mlp_kernel.mlp_train_cuda(params, x, target)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.cuda
def test_admma_eval_and_apprx_launch_their_kernels(cuda):
    """Eval mode runs K4's forward every iteration; apprx=2 runs it for
    iterations 0..2 and the projection kernel after; neither calls a plain
    function. The decisions agree with the plain route's on the same
    input."""
    from ldpc_decoders_tpu_torch.decoders.admma import ADMMADecoder
    from ldpc_decoders_tpu_torch.ops import admm_kernel as ak
    from ldpc_decoders_tpu_torch.ops import mlp_kernel

    code = get_code("1200_3_6_ldpc")
    llr = _admm_llr(code, "biawgn", 2.5, 256, cuda, seed=5)
    counters = _step_counters()
    for apprx in (-1, 2):
        dec = ADMMADecoder(code.graph, layers=[100, 100], apprx=apprx,
                           max_iter=30, cache_dir=COMMITTED_CACHE,
                           device=cuda)
        start = [c.launches for c in counters]
        x_hat, iters = dec.decode(llr)
        torch.cuda.synchronize()
        loops = int(iters.max()) + (int(iters.max()) < 30)
        mlp_loops = loops if apprx < 0 else min(loops, apprx + 1)
        assert [c.launches - s0 for c, s0 in zip(counters, start)] == \
            [loops, loops - mlp_loops, loops, mlp_loops, 0]
        params = list(dec.mlp.parameters())

        def plain_z(it, v, _apprx=apprx):
            if 0 < _apprx < it:
                return ak.project_parity_polytope(v, mask=dec.tables.cmask)
            with torch.no_grad():
                return mlp_kernel.mlp_forward_plain(
                    params, v.reshape(-1, 6)).reshape(v.shape)

        xp, ip, _ = ak.admm_decode_plain(llr, dec.tables, mu=3.0, eps=1e-5,
                                         max_iter=30,
                                         n_edge=code.graph.n_edge,
                                         z_update=plain_z)
        assert float((xp != x_hat).any(dim=1).float().mean()) <= 0.01
