"""PyTorch port on the card: the CUDA min-sum and SPA kernels against their
plain PyTorch versions, bit for bit (decisions and iteration counts).
Marked ``cuda`` and skipped without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoders_tpu_torch.channels import biawgn, bsc  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.ops import msa_kernel, spa_kernel  # noqa: E402
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
