"""PyTorch port on the card: the CUDA min-sum kernel against its plain
PyTorch version. Marked ``cuda`` and skipped without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from ldpc_decoders_tpu_torch.channels import biawgn  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.ops import msa_kernel  # noqa: E402


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
    t = msa_kernel.msa_tables(code.graph.to(cuda))
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
    t = msa_kernel.msa_tables(get_code("1200_3_6_ldpc").graph.to(cuda))
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
