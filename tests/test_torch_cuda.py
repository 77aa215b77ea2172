"""PyTorch port on the card: the CUDA min-sum, SPA, erasure and ADMM
kernels against their plain PyTorch versions, bit for bit (decisions and
iteration counts; ADMM's fractional x too), single-cap and with ``caps=``
snapshot planes.
Marked ``cuda`` and skipped without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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
