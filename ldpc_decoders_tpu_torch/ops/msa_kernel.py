"""Whole-loop min-sum BP decode: the CUDA kernel's wrapper and its plain
PyTorch version.

``msa_decode`` picks the route by the device of ``llr``: a CPU tensor runs
``msa_decode_plain``; a CUDA tensor launches the hand-written kernel
``csrc/msa_decode.cu`` (the port of
``ldpc_decoders_tpu/ops/pallas_bp.py:_kernel``) or raises. There is no
fallback from the kernel to the plain version.

Both routes follow the Pallas kernel's semantics, not the JAX gather
route's (the two differ in bf16):

- the first v2c is msg(llr); afterwards v2c = msg(f32(msg(marg)) - c2v),
  i.e. the marginal is rounded to the message type BEFORE the subtraction;
- check node: leave-one-out two-min with the first minimal slot as argmin,
  times the parity of the other slots' ``p < 0``; the 1e30 degree-1 guard;
- marg = llr + (sum of c2v over the variable's slots, added one at a time
  in slot order — no ``tensor.sum(dim)``, whose order is not fixed), so
  the plain version and the kernel are bit-equal in bf16 AND in f32;
- x_hat = marg < 0; the syndrome is checked on the updated x_hat after
  every iteration (``check_init`` adds a check before the first); a word
  whose syndrome passes is frozen; ``iters`` counts its active iterations.

With ``caps`` (ascending positive iteration caps, ``max_iter ==
caps[-1]``) both routes return ``x_hats [K, B, V]``: plane k holds the
decisions after ``caps[k]`` iterations, or the final ones where the word
finished earlier — bit for bit what a decode at ``max_iter=caps[k]``
returns (the ``caps=`` snapshot planes of the Pallas kernel).

The launch geometry (G warps
per word, W words per CTA, on a persistent grid) is the wrapper's own
choice, by ``msa_geometry`` from the graph and the message type; callers
have no flag for it. ``msa_decode_cuda(geometry=(G, W))`` forces one, for
tests and measurements; a geometry the card cannot take raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ldpc_decoders_tpu_torch.ops import geometry
from ldpc_decoders_tpu_torch.ops._build import load_library
from ldpc_decoders_tpu_torch.ops.caps import (
    caps_array,
    check_caps,
    fill_planes,
)
from ldpc_decoders_tpu_torch.ops.geometry import WARP, Geometry
from ldpc_decoders_tpu_torch.ops.graph import (
    BPTables,
    exclusive_sign_parity,
    syndrome_ok,
)

MSA_DEG1_GUARD = 1e30   # replaces the +inf a degree-1 check would emit
MSG_DTYPES = (torch.bfloat16, torch.float32)
MAX_CHK_DEG = 8         # kMaxD of csrc/msa_decode.cu
GROUP_WARPS = (1, 2, 4, 8)


def msa_check_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Min-sum extrinsic messages per check row: sign-parity times the
    leave-one-out min via (min1, argmin, min2). [..., C, Dc] -> same.
    ``argmin`` returns the first minimal slot, so a tie gives min2 == min1."""
    mg = torch.where(mask, rows.abs(), torch.inf)
    neg = (mask & (rows < 0)).to(torch.int32)
    min1 = mg.amin(dim=-1, keepdim=True)
    amin = mg.argmin(dim=-1, keepdim=True)
    is_min = torch.arange(mg.shape[-1], device=mg.device) == amin
    min2 = torch.where(is_min, torch.inf, mg).amin(dim=-1, keepdim=True)
    ext = torch.where(is_min, min2, min1).clamp_max(MSA_DEG1_GUARD)
    return (ext * exclusive_sign_parity(neg)).to(rows.dtype)


def msa_decode_plain(llr: torch.Tensor, t: BPTables, *, max_iter: int,
                     check_init: bool, msg_dtype: torch.dtype,
                     caps: Optional[Sequence[int]] = None) -> tuple:
    """The plain PyTorch version: llr [B, V] -> (x_hat [B, V] int32,
    iters [B] int32), batched over [B, C, Dc] tensors with done masks;
    with ``caps`` the first output is x_hats [K, B, V]."""
    snaps = check_caps(caps, max_iter)
    f32 = torch.float32

    def rnd(v):
        return v.to(msg_dtype).to(f32)

    llr = llr.to(f32)
    B = llr.shape[0]
    C, Dc = t.chk_var.shape
    Dv = t.var_slot.shape[1]
    marg = llr.clone()
    c2v = torch.zeros((B, C, Dc), dtype=f32, device=llr.device)
    x_hat = llr < 0
    done = (syndrome_ok(x_hat, t) if check_init
            else torch.zeros(B, dtype=torch.bool, device=llr.device))
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    x_hats = [None] * len(snaps)
    for it in range(1, max_iter + 1):
        if bool(done.all()):
            break
        v2c = rnd(rnd(marg[:, t.chk_var]) - c2v)
        c2v_new = rnd(msa_check_rows(v2c, t.cmask))
        flat = c2v_new.reshape(B, C * Dc)
        acc = torch.zeros_like(llr)
        for s in range(Dv):            # slot order, one add at a time
            acc = acc + torch.where(t.vmask[:, s], flat[:, t.var_slot[:, s]],
                                    0.0)
        active = ~done
        marg = torch.where(active[:, None], llr + acc, marg)
        c2v = torch.where(active[:, None, None], c2v_new, c2v)
        x_hat = marg < 0
        iters += active.to(torch.int32)
        done = done | syndrome_ok(x_hat, t)
        if it in snaps:
            x_hats[snaps.index(it)] = x_hat.to(torch.int32)
    return fill_planes(x_hats, x_hat.to(torch.int32), caps), iters


def _align16(n: int) -> int:
    return (n + 15) & ~15


def make_geometry(C: int, V: int, Dc: int, Dv: int, bf16: bool,
                  group_warps: int, words: int) -> Geometry:
    """``group_warps`` warps per word and ``words`` per CTA on a [C, Dc]
    graph with V variables of degree up to Dv, or ValueError where the
    kernel or the card cannot take it. Shared memory per word: the f32
    marginals and the c2v messages in the message type; the index tables
    are read through L1."""
    if Dc > MAX_CHK_DEG:
        raise ValueError(f"check degree {Dc} > {MAX_CHK_DEG}: the kernel "
                         "keeps a check row's sign bits in 8 bits")
    if group_warps not in GROUP_WARPS:
        raise ValueError(f"warps per word must be one of {GROUP_WARPS}, got "
                         f"{group_warps}")
    if group_warps > 1 and words > 1:
        raise ValueError(f"{words} words per CTA of {group_warps} warps "
                         "each: a word of more than one warp is its CTA")
    msg_bytes = 2 if bf16 else 4
    return geometry.make_geometry(
        WARP * group_warps, _align16(4 * V) + _align16(msg_bytes * Dc * C),
        words)


def msa_geometry(C: int, V: int, Dc: int, Dv: int, bf16: bool) -> Geometry:
    """The wrapper's rule, ``geometry.group_rule`` over this kernel's
    shared memory. An H100 gets 8 warps per word on LDPC(1200,3,6) and
    margulis, and 32 words of one warp per CTA on Hamming(7,4)."""
    return geometry.group_rule(
        lambda g, w: make_geometry(C, V, Dc, Dv, bf16, g, w), C, GROUP_WARPS)


def msa_decode_cuda(llr: torch.Tensor, t: BPTables, *, max_iter: int,
                    check_init: bool, msg_dtype: torch.dtype,
                    caps: Optional[Sequence[int]] = None,
                    geometry: Optional[tuple] = None) -> tuple:
    """Launch ``csrc/msa_decode.cu`` on the current stream (no sync), at
    the geometry ``msa_geometry`` picks for this graph and message type.
    ``geometry`` = (warps per word, words per CTA) forces one; it is for
    tests and measurements. Counts single-cap launches in
    ``msa_decode_cuda.launches`` and ``caps=`` launches in
    ``msa_decode_cuda.launches_caps``."""
    snaps = check_caps(caps, max_iter)
    if not llr.is_cuda:
        raise ValueError("msa_decode_cuda needs a CUDA tensor")
    if llr.dtype != torch.float32 or llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, V] float32 tensor")
    if msg_dtype not in MSG_DTYPES:
        raise ValueError(f"no kernel for message type {msg_dtype}")
    Dc, C = t.k_chk_var.shape
    Dv, V = t.k_var_slot.shape
    if llr.shape[1] != V:
        raise ValueError(f"llr has {llr.shape[1]} variables, graph has {V}")
    bf16 = msg_dtype == torch.bfloat16
    geo = (msa_geometry(C, V, Dc, Dv, bf16) if geometry is None
           else make_geometry(C, V, Dc, Dv, bf16, *geometry))
    for tab in (t.k_chk_var, t.k_var_slot):
        if (tab.device != llr.device or tab.dtype != torch.int32
                or not tab.is_contiguous()):
            raise ValueError("kernel tables must be contiguous int32 on the "
                             "device of llr")
    cap_arr = caps_array(snaps)
    lib = _kernel_library()
    B = llr.shape[0]
    x_hats = torch.empty((len(snaps), B, V), dtype=torch.int32,
                         device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    next_word = torch.zeros((1,), dtype=torch.int32, device=llr.device)
    stream = torch.cuda.current_stream(llr.device).cuda_stream
    with torch.cuda.device(llr.device):
        rc = lib.msa_decode_launch(
            llr.data_ptr(), t.k_chk_var.data_ptr(), t.k_var_slot.data_ptr(),
            x_hats.data_ptr(), iters.data_ptr(), next_word.data_ptr(), B, C,
            V, Dc, Dv, int(max_iter), int(bool(check_init)), int(bf16),
            cap_arr, len(snaps), geo.threads // WARP, geo.words, stream)
    if rc != 0:
        raise RuntimeError(
            f"msa_decode kernel launch failed at {geo.threads // WARP} warps "
            f"per word and {geo.words} words per CTA "
            f"({geo.table_bytes + geo.words * geo.smem_bytes} bytes of shared "
            "memory): " + lib.msa_decode_error_string(rc).decode())
    if caps is None:
        msa_decode_cuda.launches += 1
        return x_hats[0], iters
    msa_decode_cuda.launches_caps += 1
    return x_hats, iters


msa_decode_cuda.launches = 0
msa_decode_cuda.launches_caps = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("msa_decode")
    if lib.msa_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.msa_decode_launch.argtypes = ([p] * 6 + [i] * 8
                                          + [ctypes.POINTER(i), i, i, i, p])
        lib.msa_decode_launch.restype = i
        lib.msa_decode_error_string.argtypes = [i]
        lib.msa_decode_error_string.restype = ctypes.c_char_p
    return lib


def msa_decode(llr: torch.Tensor, t: BPTables, *, max_iter: int,
               check_init: bool, msg_dtype: torch.dtype,
               caps: Optional[Sequence[int]] = None) -> tuple:
    """Route by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    kw = dict(max_iter=max_iter, check_init=check_init, msg_dtype=msg_dtype,
              caps=caps)
    if llr.is_cuda:
        return msa_decode_cuda(llr, t, **kw)
    if llr.device.type == "cpu":
        return msa_decode_plain(llr, t, **kw)
    raise ValueError(f"no min-sum route for device {llr.device}")
