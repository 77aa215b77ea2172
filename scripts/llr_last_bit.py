"""Word error rate of float32 min-sum on the BSC against the last bits of
the LLR magnitude, on the port.

    python scripts/llr_last_bit.py 1200_3_6_rand_ldpc_7 0.041 10 \
        [--batch 2048] [--ulps 4] [--device cpu]

Every message of a BSC min-sum decode is a multiple of L = log((1-p)/p),
so ties between sums hang on L's last bits. The script draws one set of
flips (numpy, seed 5, codeword 1) and decodes it with L set to the
correctly rounded float32 value and to each of its neighbours up to
``--ulps`` away; it prints the WER at each, and the L the port's channel
computes on the device (``channels.bsc.llr``).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ldpc_decoders_tpu_torch.channels import bsc  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.bp import BPDecoder  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("code")
    ap.add_argument("p", type=float)
    ap.add_argument("cap", type=int)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--ulps", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    code = get_code(args.code)
    dev = torch.device(args.device)
    mag0 = np.float32(np.log((1 - args.p) / args.p))
    on_device = float(bsc.llr(torch.zeros(1, dtype=torch.int32, device=dev),
                              args.p)[0])
    print(f"{args.code} p={args.p} cap {args.cap} B={args.batch}: correctly "
          f"rounded L {mag0!r}, channels.bsc.llr on {dev} "
          f"{np.float32(on_device)!r}")
    flips = np.random.default_rng(5).random((args.batch, code.get_n())) < args.p
    dec = BPDecoder(code.graph, "MSA", max_iter=args.cap,
                    msg_dtype="float32", check_init=True, device=dev)
    for ulp in range(-args.ulps, args.ulps + 1):
        mag = mag0
        for _ in range(abs(ulp)):
            mag = np.nextafter(mag, np.float32(np.inf if ulp > 0 else 0.0))
        llr = torch.from_numpy(np.where(flips, mag, -mag).astype(np.float32))
        x_hat, _ = dec.decode(llr.to(dev))
        wer = float((x_hat != 1).any(dim=1).float().mean())
        print(f"  L {ulp:+d} ulp = {mag!r}: WER {wer:.6f}")


if __name__ == "__main__":
    main()
