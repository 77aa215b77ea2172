"""Plain min-sum belief propagation, the arithmetic the program states for
its min-sum decode (its CUDA kernel and its plain version agree bit for
bit):

- messages are rounded to the message type (bfloat16 here; the control
  passes a lower one) and computed in float32: the first variable-to-check
  message is msg(llr), later ones msg(f32(msg(marg)) - c2v);
- a check sends each slot the least magnitude of its other slots (the
  first least slot is the argmin, so a tie gives min2 == min1), capped at
  1e30, times the parity of the other slots' signs;
- marg = llr + the variable's incoming messages added one at a time in
  slot order; x_hat = marg < 0;
- the syndrome is tested on x_hat after every iteration (not before the
  first); a word whose syndrome passes is done, keeps its decisions, and
  ``iters`` counts the iterations it ran.

Words are independent, so the loop drops done words from its batch as it
goes: the arithmetic of a word does not depend on which others share it.
"""

from __future__ import annotations

import torch

from portbench.reference.codes import Tables

F32 = torch.float32
DEG1_GUARD = 1e30


def syndrome_ok(x_hat: torch.Tensor, t: Tables) -> torch.Tensor:
    bits = (x_hat[:, t.chk_var] & t.cmask).to(torch.int32)
    return (bits.sum(dim=-1) % 2 == 0).all(dim=-1)


def check_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """rows [..., C, D] -> the messages each check sends its slots: the
    least magnitude of the other slots (min2 at the first least slot, min1
    elsewhere), capped at 1e30, times the parity of the other slots'
    signs."""
    mag = torch.where(mask, rows.abs(), torch.inf)
    neg = (mask & (rows < 0)).to(torch.int32)
    min1 = mag.amin(dim=-1, keepdim=True)
    first = mag.argmin(dim=-1, keepdim=True)
    is_min = torch.arange(mag.shape[-1], device=mag.device) == first
    min2 = torch.where(is_min, torch.inf, mag).amin(dim=-1, keepdim=True)
    ext = torch.where(is_min, min2, min1).clamp_max(DEG1_GUARD)
    others_neg = neg.sum(dim=-1, keepdim=True) - neg
    return (ext * (1 - 2 * (others_neg % 2))).to(rows.dtype)


def decode(llr: torch.Tensor, t: Tables, max_iter: int,
           msg_dtype: torch.dtype) -> tuple:
    """llr [B, V] float32 -> (x_hat [B, V] int32, iters [B] int32)."""

    def rnd(v):
        return v.to(msg_dtype).to(F32)

    B, V = llr.shape
    C, Dc = t.chk_var.shape
    x_out = (llr < 0).to(torch.int32)
    it_out = torch.zeros(B, dtype=torch.int32, device=llr.device)
    live = torch.arange(B, device=llr.device)
    prior = llr
    marg = llr.clone()
    c2v = torch.zeros((B, C, Dc), dtype=F32, device=llr.device)
    for it in range(1, max_iter + 1):
        v2c = rnd(rnd(marg[:, t.chk_var]) - c2v)
        c2v = rnd(check_rows(v2c, t.cmask))
        flat = c2v.reshape(-1, C * Dc)
        acc = torch.zeros_like(prior)
        for s in range(t.var_slot.shape[1]):
            acc = acc + torch.where(t.vmask[:, s], flat[:, t.var_slot[:, s]],
                                    0.0)
        marg = prior + acc
        x_hat = marg < 0
        done = syndrome_ok(x_hat, t)
        x_out[live] = x_hat.to(torch.int32)
        it_out[live] = it
        keep = (~done).nonzero().squeeze(1)
        if keep.numel() == 0:
            break
        if keep.numel() < live.numel():
            live, prior, marg = live[keep], prior[keep], marg[keep]
            c2v = c2v[keep]
    return x_out, it_out
