"""Whole-loop sum-product (SPA) BP decode under both inf policies: the CUDA
kernels' wrapper and their plain PyTorch version.

``spa_decode`` picks the route by the device of ``llr``: a CPU tensor runs
``spa_decode_plain``; a CUDA tensor launches the hand-written kernel
``csrc/spa_decode.cu`` or raises. There is no fallback from the kernel to
the plain version. One source holds both TPU kernels' ports:

- ``inf_policy="saturate"``: ``ldpc_decoders_tpu/ops/pallas_bp.py:_spa_kernel``
  (clean phi-domain SPA, messages capped at LLR_CLIP);
- ``inf_policy="reference"``: ``pallas_bp.py:_spa_ref_kernel``, the
  reference decoder's float64 inf/NaN cascade with sentinels (+-inf is
  +-INF_S, NaN is NAN_S), which the committed SPA goldens depend on.

Both routes follow the Pallas kernels' semantics:

- the first v2c is msg(llr); the check output c2v stays float32 and is
  rounded to the message type only where it enters the marginal sum;
  v2c = msg(msg(marg) - c2v) (saturate), or the sentinel rules of
  ``_spa_ref_step`` on msg(marg) and c2v (reference);
- the leave-one-out phi sum is ``exclusive_sum`` (prefix + suffix folded
  one slot at a time), and marg = llr + (the variable's slots summed one at
  a time in slot order), so the plain version and the kernel are bit-equal
  on the card in bf16 and in f32;
- the reference policy's "every other factor saturated" test counts
  against each check's real degree, so padded irregular rows work;
- x_hat = marg < 0 (a NaN marginal decides bit 0), the syndrome is checked
  on the updated x_hat after every iteration (``check_init`` adds a check
  before the first), a word whose syndrome passes is frozen, and ``iters``
  counts its active iterations;
- with ``caps`` (ascending positive iteration caps, ``max_iter ==
  caps[-1]``) both routes return ``x_hats [K, B, V]``: plane k holds the
  decisions after ``caps[k]`` iterations, or the final ones where the word
  finished earlier, through the same decision rule as the final output.

``phi`` divides ``x * x`` by a 0-dim device tensor, not a Python scalar:
on CUDA torch divides by a host scalar as a multiply by its reciprocal,
which rounds differently from the kernel's IEEE division.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ldpc_decoders_tpu_torch.ops._build import load_library
from ldpc_decoders_tpu_torch.ops.caps import (
    caps_array,
    check_caps,
    fill_planes,
)
from ldpc_decoders_tpu_torch.ops.graph import (
    BPTables,
    exclusive_sign_parity,
    exclusive_sum,
    syndrome_ok,
)
from ldpc_decoders_tpu_torch.ops.msa_kernel import MSG_DTYPES, THREADS

# float32 phi-domain guards (decoders/bp.py of the JAX package): phi is its
# own inverse, so clipping its argument to [PHI_EPS, LLR_CLIP] with
# PHI_EPS = phi(LLR_CLIP) caps check messages at LLR_CLIP, the reference's
# effective float64 saturation.
LLR_CLIP = 38.0
PHI_EPS = 6.27e-17
# Sentinels of inf_policy="reference": +-inf is +-INF_S, NaN is NAN_S;
# classes are magnitude bands (exact in f32, distinct in bf16).
INF_S = 1e9
NAN_S = 2e9
_INF_MIN = 5e8
_NAN_MIN = 1.5e9
INF_POLICIES = ("reference", "saturate")
MAX_CHK_DEG = 8         # kMaxD of csrc/spa_decode.cu


def phi(x: torch.Tensor) -> torch.Tensor:
    """Gallager phi(x) = -log(tanh(x/2)), float32, in the JAX package's
    piecewise form: the series log(2/x) + x^2/12 below 0.1, exp/log1p
    above."""
    small = x < 0.1
    ex = torch.exp(-x)
    big = torch.log1p(ex) - torch.log1p(-torch.where(small, 0.5, ex))
    ser = (torch.log(2.0 / torch.where(small, x, 1.0))
           + x * x / torch.full((), 12.0, dtype=torch.float32,
                                  device=x.device))
    return torch.where(small, ser, big)


def spa_check_rows(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """SPA extrinsic messages per check row (saturate policy).
    [..., C, Dc] -> same; padded slots are phi-neutral."""
    mag = rows.to(torch.float32).abs().clamp(PHI_EPS, LLR_CLIP)
    ph = torch.where(mask, phi(mag), 0.0)
    neg = (mask & (rows < 0)).to(torch.int32)
    ext = phi(exclusive_sum(ph).clamp_min(PHI_EPS))
    return (ext * exclusive_sign_parity(neg)).to(rows.dtype)


def spa_check_rows_ref(rows: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """SPA check update with the reference's float64 inf/NaN semantics,
    sentinel-encoded: +-inf inputs and finite |v| >= LLR_CLIP are factors
    of exact +-1 ("saturated"); an output is sgn * INF_S iff every other
    slot of its row is saturated (the row's real degree); a NaN input
    poisons the whole row with NAN_S. Padded slots output 0."""
    a = rows.to(torch.float32)
    mag = a.abs()
    nan_i = a > _NAN_MIN
    pinf_i = (a > _INF_MIN) & ~nan_i
    ninf_i = a < -_INF_MIN
    fin_i = ~(nan_i | pinf_i | ninf_i)
    sat = (mask & (pinf_i | ninf_i | (mag >= LLR_CLIP))).to(torch.int32)
    live = mask & fin_i & (mag < LLR_CLIP)
    neg = (mask & ((fin_i & (a < 0)) | ninf_i)).to(torch.int32)

    ph = torch.where(live, phi(mag.clamp(PHI_EPS, LLR_CLIP)), 0.0)
    n_sat = sat.sum(dim=-1, keepdim=True) - sat     # exact: integer counts
    deg = mask.to(torch.int32).sum(dim=-1, keepdim=True)
    sgn = exclusive_sign_parity(neg).to(torch.float32)
    val = phi(exclusive_sum(ph).clamp_min(PHI_EPS)) * sgn
    out = torch.where(n_sat == deg - 1, sgn * INF_S, val)
    nan_row = (mask & nan_i).any(dim=-1, keepdim=True)
    out = torch.where(nan_row, NAN_S, out)
    return torch.where(mask, out, 0.0).to(rows.dtype)


def _var_sum(vals: torch.Tensor, t: BPTables) -> torch.Tensor:
    """[B, C, Dc] -> [B, V]: each variable's slots added one at a time in
    slot order (no ``tensor.sum(dim)``, whose order is not fixed)."""
    flat = vals.reshape(vals.shape[0], -1)
    acc = torch.zeros((vals.shape[0], t.var_slot.shape[0]), dtype=vals.dtype,
                      device=vals.device)
    for s in range(t.var_slot.shape[1]):
        acc = acc + torch.where(t.vmask[:, s], flat[:, t.var_slot[:, s]], 0)
    return acc


def _check_policy(inf_policy: str) -> None:
    if inf_policy not in INF_POLICIES:
        raise ValueError(f"unknown inf_policy {inf_policy!r}")


def spa_decode_plain(llr: torch.Tensor, t: BPTables, *, max_iter: int,
                     check_init: bool, msg_dtype: torch.dtype,
                     inf_policy: str,
                     caps: Optional[Sequence[int]] = None) -> tuple:
    """The plain PyTorch version: llr [B, V] -> (x_hat [B, V] int32,
    iters [B] int32), batched over [B, C, Dc] tensors with done masks;
    with ``caps`` the first output is x_hats [K, B, V]."""
    _check_policy(inf_policy)
    snaps = check_caps(caps, max_iter)
    ref = inf_policy == "reference"
    f32 = torch.float32

    def rnd(v):
        return v.to(msg_dtype).to(f32)

    llr = llr.to(f32)
    B = llr.shape[0]
    v2c = rnd(llr[:, t.chk_var])
    marg = llr.clone()
    x_hat = llr < 0
    done = (syndrome_ok(x_hat, t) if check_init
            else torch.zeros(B, dtype=torch.bool, device=llr.device))
    iters = torch.zeros(B, dtype=torch.int32, device=llr.device)
    x_hats = [None] * len(snaps)
    for it in range(1, max_iter + 1):
        if bool(done.all()):
            break
        if ref:
            c2v = spa_check_rows_ref(v2c, t.cmask)
            cn = c2v > _NAN_MIN
            cp = (c2v > _INF_MIN) & ~cn
            cm = c2v < -_INF_MIN
            finv = torch.where(cn | cp | cm, 0.0, c2v)
            n_p = _var_sum((cp | cn).to(torch.int32), t)
            n_n = _var_sum((cm | cn).to(torch.int32), t)
            is_nan = (n_p > 0) & (n_n > 0)
            marg_new = torch.where(
                is_nan, NAN_S, torch.where(
                    n_p > 0, INF_S, torch.where(
                        n_n > 0, -INF_S, llr + _var_sum(rnd(finv), t))))
            ed = rnd(marg_new)[:, t.chk_var]
            em_nan = ed > _NAN_MIN
            em_p = (ed > _INF_MIN) & ~em_nan
            em_n = ed < -_INF_MIN
            nv = torch.where(em_p, torch.where(cp, NAN_S, INF_S), ed - finv)
            nv = torch.where(em_n, torch.where(cm, NAN_S, -INF_S), nv)
            nv = torch.where(em_nan, NAN_S, nv)
        else:
            c2v = spa_check_rows(v2c, t.cmask)
            marg_new = llr + _var_sum(rnd(c2v), t)
            nv = rnd(marg_new)[:, t.chk_var] - c2v
        active = ~done
        marg = torch.where(active[:, None], marg_new, marg)
        v2c = torch.where(active[:, None, None], rnd(nv), v2c)
        x_hat = marg < 0
        iters += active.to(torch.int32)
        done = done | syndrome_ok(x_hat, t)
        if it in snaps:
            x_hats[snaps.index(it)] = x_hat.to(torch.int32)
    return fill_planes(x_hats, x_hat.to(torch.int32), caps), iters


def spa_decode_cuda(llr: torch.Tensor, t: BPTables, *, max_iter: int,
                    check_init: bool, msg_dtype: torch.dtype,
                    inf_policy: str,
                    caps: Optional[Sequence[int]] = None) -> tuple:
    """Launch ``csrc/spa_decode.cu`` on the current stream (no sync).
    Counts launches per policy: single-cap in ``spa_decode_cuda.launches``,
    ``caps=`` in ``spa_decode_cuda.launches_caps``."""
    _check_policy(inf_policy)
    snaps = check_caps(caps, max_iter)
    if not llr.is_cuda:
        raise ValueError("spa_decode_cuda needs a CUDA tensor")
    if llr.dtype != torch.float32 or llr.dim() != 2 or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, V] float32 tensor")
    if msg_dtype not in MSG_DTYPES:
        raise ValueError(f"no kernel for message type {msg_dtype}")
    Dc, C = t.k_chk_var.shape
    Dv, V = t.k_var_slot.shape
    if llr.shape[1] != V:
        raise ValueError(f"llr has {llr.shape[1]} variables, graph has {V}")
    if Dc > MAX_CHK_DEG:
        raise ValueError(f"check degree {Dc} > {MAX_CHK_DEG}: the kernel "
                         "keeps a check row in registers")
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
    stream = torch.cuda.current_stream(llr.device).cuda_stream
    with torch.cuda.device(llr.device):
        rc = lib.spa_decode_launch(
            llr.data_ptr(), t.k_chk_var.data_ptr(), t.k_var_slot.data_ptr(),
            x_hats.data_ptr(), iters.data_ptr(), B, C, V, Dc, Dv,
            int(max_iter), int(bool(check_init)),
            int(msg_dtype == torch.bfloat16),
            int(inf_policy == "reference"), cap_arr, len(snaps), THREADS,
            stream)
    if rc != 0:
        raise RuntimeError("spa_decode kernel launch failed: "
                           + lib.spa_decode_error_string(rc).decode())
    if caps is None:
        spa_decode_cuda.launches[inf_policy] += 1
        return x_hats[0], iters
    spa_decode_cuda.launches_caps[inf_policy] += 1
    return x_hats, iters


spa_decode_cuda.launches = dict.fromkeys(INF_POLICIES, 0)
spa_decode_cuda.launches_caps = dict.fromkeys(INF_POLICIES, 0)


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("spa_decode")
    if lib.spa_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spa_decode_launch.argtypes = ([p, p, p, p, p] + [i] * 9
                                          + [ctypes.POINTER(i), i, i, p])
        lib.spa_decode_launch.restype = i
        lib.spa_decode_error_string.argtypes = [i]
        lib.spa_decode_error_string.restype = ctypes.c_char_p
    return lib


def spa_decode(llr: torch.Tensor, t: BPTables, *, max_iter: int,
               check_init: bool, msg_dtype: torch.dtype, inf_policy: str,
               caps: Optional[Sequence[int]] = None) -> tuple:
    """Route by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    kw = dict(max_iter=max_iter, check_init=check_init, msg_dtype=msg_dtype,
              inf_policy=inf_policy, caps=caps)
    if llr.is_cuda:
        return spa_decode_cuda(llr, t, **kw)
    if llr.device.type == "cpu":
        return spa_decode_plain(llr, t, **kw)
    raise ValueError(f"no SPA route for device {llr.device}")
