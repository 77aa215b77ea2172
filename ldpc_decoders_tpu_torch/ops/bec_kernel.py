"""Whole-loop ternary erasure SPA decode for the binary erasure channel:
the CUDA kernel's wrapper and its plain PyTorch version.

``bec_spa_decode`` picks the route by the device of ``y``: a CPU tensor
runs ``bec_spa_decode_plain``; a CUDA tensor launches the hand-written
kernel ``csrc/bec_decode.cu`` (the port of
``ldpc_decoders_tpu/ops/pallas_bp.py:_bec_kernel``) or raises. There is no
fallback from the kernel to the plain version.

Semantics (the JAX package's ``decoders/bec_spa.py`` gather route and its
Pallas kernel, which are bit-equal to each other; all values are small
integers, so both routes here are exact):

- channel symbols {0, 1, 2} (2 = erasure) become priors {-1, +1, 0};
  ``x_hat`` starts as the priors and the first v2c on every edge is the
  prior; a word with no erasure is done at once with ``iters = 0``;
- check pass, over a row's real slots: ``unknowns`` counts v2c == 0,
  ``ones`` counts v2c > 0. No unknown: every slot gets its OWN message
  back (an echo, not extrinsic). Exactly one: the unknown slot gets
  2 * (ones mod 2) - 1, every other slot 0. Two or more: all 0;
- variable pass: marg = prior + sum of c2v; v2c = sign(marg[var] - c2v);
  x_new = sign(marg);
- a word is done when no erasure is left in x_hat or x_new equals x_hat in
  all V positions (a stopping set); the iteration that detects the stop
  counts in ``iters``;
- output: sign -1 / 0 / +1 -> symbol 0 / 2 / 1.

With ``caps`` (ascending positive iteration caps, ``max_iter ==
caps[-1]``) plane k of the output holds the symbols after ``caps[k]``
iterations, or the final state where the word stopped earlier.

The launch geometry (G warps per word, W words per CTA, on a persistent
grid) is the wrapper's own choice, by ``bec_geometry`` from the graph;
callers have no flag for it. ``bec_spa_decode_cuda(geometry=(G, W))``
forces one, for tests and measurements; a geometry the card cannot take
raises.
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
from ldpc_decoders_tpu_torch.ops.graph import BPTables

ERASURE = 2
MAX_CHK_DEG = 8         # kMaxD of csrc/bec_decode.cu
MAX_TABLE_INDEX = 32767  # the kernel's 16-bit index tables
GROUP_WARPS = (1, 2, 4, 8)


def _to_symbols(sign: torch.Tensor) -> torch.Tensor:
    two = torch.full((), ERASURE, dtype=torch.int32, device=sign.device)
    return torch.where(sign == 0, two, (sign > 0).to(torch.int32))


def bec_spa_decode_plain(y: torch.Tensor, t: BPTables, *, max_iter: int,
                         caps: Optional[Sequence[int]] = None) -> tuple:
    """The plain PyTorch version: y [B, V] in {0,1,2} -> (x_hat [B, V]
    int32 in {0,1,2}, iters [B] int32); with ``caps`` the first output is
    x_hats [K, B, V]. Batched over [B, C, Dc] int8 tensors with done
    masks."""
    snaps = check_caps(caps, max_iter)
    i8 = torch.int8
    B = y.shape[0]
    C, Dc = t.chk_var.shape
    prior = torch.where(y == ERASURE, 0, 2 * y - 1).to(i8)
    marg = prior.clone()
    c2v = torch.zeros((B, C, Dc), dtype=i8, device=y.device)
    done = (prior != 0).all(dim=-1)
    iters = torch.zeros(B, dtype=torch.int32, device=y.device)
    x_hats = [None] * len(snaps)
    it = 0
    while it < max_iter and not bool(done.all()):
        # Padded slots read as -1: known and not positive, so neutral for
        # both counts.
        m = torch.where(t.cmask, torch.sign(marg[:, t.chk_var] - c2v), -1)
        unknowns = (m == 0).sum(dim=-1, keepdim=True)
        ones = (m > 0).sum(dim=-1, keepdim=True)
        parity = (2 * (ones % 2) - 1).to(i8)
        c2v_new = torch.where(
            unknowns == 0, m,
            torch.where(unknowns == 1, (1 - m.abs()) * parity, 0))
        flat = c2v_new.reshape(B, C * Dc)
        marg_new = prior + torch.where(
            t.vmask, flat[:, t.var_slot], 0).sum(dim=-1, dtype=i8)
        active = ~done
        stopped = active & (torch.sign(marg_new)
                            == torch.sign(marg)).all(dim=-1)
        marg = torch.where(active[:, None], marg_new, marg)
        c2v = torch.where(active[:, None, None], c2v_new, c2v)
        iters += active.to(torch.int32)
        done = done | (marg != 0).all(dim=-1) | stopped
        it += 1
        if it in snaps:
            x_hats[snaps.index(it)] = _to_symbols(torch.sign(marg))
    return fill_planes(x_hats, _to_symbols(torch.sign(marg)), caps), iters


def _align16(n: int) -> int:
    return (n + 15) & ~15


def make_geometry(C: int, V: int, Dc: int, Dv: int, group_warps: int,
                  words: int) -> Geometry:
    """``group_warps`` warps per word and ``words`` per CTA on a [C, Dc]
    graph with V variables of degree up to Dv, or ValueError where the
    kernel or the card cannot take it. Shared memory per word: the c2v
    messages, priors and marginals, one byte each; per CTA: the 16-bit
    index tables."""
    if Dc > MAX_CHK_DEG:
        raise ValueError(f"check degree {Dc} > {MAX_CHK_DEG}: the kernel "
                         "keeps a check row's slot masks in 8 bits")
    if Dv > 126:
        raise ValueError(f"variable degree {Dv} > 126 (int8 marginals)")
    if V > MAX_TABLE_INDEX or Dc * C > MAX_TABLE_INDEX:
        raise ValueError(f"a graph of {C} checks and {V} variables does not "
                         "fit the kernel's 16-bit index tables")
    if group_warps not in GROUP_WARPS:
        raise ValueError(f"warps per word must be one of {GROUP_WARPS}, got "
                         f"{group_warps}")
    if group_warps > 1 and words > 1:
        raise ValueError(f"{words} words per CTA of {group_warps} warps "
                         "each: a word of more than one warp is its CTA")
    return geometry.make_geometry(
        WARP * group_warps, _align16(Dc * C + 2 * V), words,
        _align16(2 * (Dc * C + Dv * V)))


def bec_geometry(C: int, V: int, Dc: int, Dv: int) -> Geometry:
    """The wrapper's rule, ``geometry.group_rule`` over this kernel's
    shared memory. An H100 gets 8 warps per word on LDPC(1200,3,6) and
    margulis, and 32 words of one warp per CTA on Hamming(7,4)."""
    return geometry.group_rule(
        lambda g, w: make_geometry(C, V, Dc, Dv, g, w), C, GROUP_WARPS)


def bec_spa_decode_cuda(y: torch.Tensor, t: BPTables, *, max_iter: int,
                        caps: Optional[Sequence[int]] = None,
                        geometry: Optional[tuple] = None) -> tuple:
    """Launch ``csrc/bec_decode.cu`` on the current stream (no sync), at
    the geometry ``bec_geometry`` picks for this graph. ``geometry`` =
    (warps per word, words per CTA) forces one; it is for tests and
    measurements. Counts single-cap launches in
    ``bec_spa_decode_cuda.launches`` and ``caps=`` launches in
    ``bec_spa_decode_cuda.launches_caps``."""
    snaps = check_caps(caps, max_iter)
    if not y.is_cuda:
        raise ValueError("bec_spa_decode_cuda needs a CUDA tensor")
    if y.dtype != torch.int32 or y.dim() != 2 or not y.is_contiguous():
        raise ValueError("y must be a contiguous [B, V] int32 tensor")
    Dc, C = t.k_chk_var.shape
    Dv, V = t.k_var_slot.shape
    if y.shape[1] != V:
        raise ValueError(f"y has {y.shape[1]} variables, graph has {V}")
    geo = (bec_geometry(C, V, Dc, Dv) if geometry is None
           else make_geometry(C, V, Dc, Dv, *geometry))
    for tab in (t.k_chk_var, t.k_var_slot):
        if (tab.device != y.device or tab.dtype != torch.int32
                or not tab.is_contiguous()):
            raise ValueError("kernel tables must be contiguous int32 on the "
                             "device of y")
    cap_arr = caps_array(snaps)
    lib = _kernel_library()
    B = y.shape[0]
    x_hats = torch.empty((len(snaps), B, V), dtype=torch.int32,
                         device=y.device)
    iters = torch.empty((B,), dtype=torch.int32, device=y.device)
    next_word = torch.zeros((1,), dtype=torch.int32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        rc = lib.bec_decode_launch(
            y.data_ptr(), t.k_chk_var.data_ptr(), t.k_var_slot.data_ptr(),
            x_hats.data_ptr(), iters.data_ptr(), next_word.data_ptr(), B, C,
            V, Dc, Dv, int(max_iter), cap_arr, len(snaps),
            geo.threads // WARP, geo.words, stream)
    if rc != 0:
        raise RuntimeError(
            f"bec_decode kernel launch failed at {geo.threads // WARP} warps "
            f"per word and {geo.words} words per CTA "
            f"({geo.table_bytes + geo.words * geo.smem_bytes} bytes of shared "
            "memory): " + lib.bec_decode_error_string(rc).decode())
    if caps is None:
        bec_spa_decode_cuda.launches += 1
        return x_hats[0], iters
    bec_spa_decode_cuda.launches_caps += 1
    return x_hats, iters


bec_spa_decode_cuda.launches = 0
bec_spa_decode_cuda.launches_caps = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("bec_decode")
    if lib.bec_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bec_decode_launch.argtypes = ([p] * 6 + [i] * 6
                                          + [ctypes.POINTER(i), i, i, i, p])
        lib.bec_decode_launch.restype = i
        lib.bec_decode_error_string.argtypes = [i]
        lib.bec_decode_error_string.restype = ctypes.c_char_p
    return lib


def bec_spa_decode(y: torch.Tensor, t: BPTables, *, max_iter: int,
                   caps: Optional[Sequence[int]] = None) -> tuple:
    """Route by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if y.is_cuda:
        return bec_spa_decode_cuda(y, t, max_iter=max_iter, caps=caps)
    if y.device.type == "cpu":
        return bec_spa_decode_plain(y, t, max_iter=max_iter, caps=caps)
    raise ValueError(f"no erasure-SPA route for device {y.device}")
