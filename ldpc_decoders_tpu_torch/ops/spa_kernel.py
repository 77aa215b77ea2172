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

With bf16 messages the kernel reads the input phi from a table of phi over
the 7,561 values a clipped bf16 magnitude can take (``phi_table_inputs``,
indexed by ``phi_table_index``), which the kernel's own ``phi`` fills on
the device at first use (``phi_table_cuda``, one per device). The plain
version keeps calling ``phi``: it is the specification the table is held
against.

The launch geometry is the wrapper's own choice, by ``spa_geometry`` from
the graph and the message type; callers have no flag for it. ``spa_decode_cuda(threads=...)``
forces a thread count, for tests and measurements; a geometry the card
cannot take raises. The outputs do not depend on it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ldpc_decoders_tpu_torch.ops import geometry
from ldpc_decoders_tpu_torch.ops._build import load_library
from ldpc_decoders_tpu_torch.ops.caps import (
    caps_array,
    check_caps,
    fill_planes,
)
from ldpc_decoders_tpu_torch.ops.geometry import (
    WARP,
    Geometry,
    row_threads,
    words_per_sm,
)
from ldpc_decoders_tpu_torch.ops.graph import (
    BPTables,
    exclusive_sign_parity,
    exclusive_sum,
    syndrome_ok,
)
from ldpc_decoders_tpu_torch.ops.msa_kernel import MSG_DTYPES

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
# The bf16 phi table (kTabFirst, kTabLast): entry 0 is phi(PHI_EPS), whose
# float32 has these top 16 bits; entry i > 0 is phi of the bf16 number with
# bit pattern PHI_TAB_FIRST + i, up to bf16(LLR_CLIP).
PHI_TAB_FIRST = 0x2490
PHI_TAB_LAST = 0x4218
PHI_TAB_SIZE = PHI_TAB_LAST - PHI_TAB_FIRST + 1        # 7561
# Warps per word (one CTA; a thread owns a check row): the few that keep
# an SM full, and more where a word's check pass is longer (f32 messages:
# two phi per edge) or an SM holds too few words by shared memory to fill
# its RESIDENT_WARPS, about what the kernel's 39-47 registers a thread let
# it hold. Set by ``scripts/profile_spa_kernel.py``'s sweep on an H100.
WORD_WARPS = 8
WORD_WARPS_MORE = 12
RESIDENT_WARPS = 48


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


def phi_table_inputs(device=None) -> torch.Tensor:
    """The float32 inputs of the bf16 phi table, in entry order: PHI_EPS,
    then every bf16 number in (PHI_EPS, LLR_CLIP]."""
    top = torch.arange(PHI_TAB_FIRST + 1, PHI_TAB_LAST + 1,
                       dtype=torch.int32, device=device)
    return torch.cat([torch.full((1,), PHI_EPS, dtype=torch.float32,
                                 device=device),
                      (top << 16).view(torch.float32)])


def phi_table_index(cl: torch.Tensor) -> torch.Tensor:
    """The kernel's table index of a clipped magnitude cl (float32): PHI_EPS
    or a bf16 number in (PHI_EPS, LLR_CLIP]. No branch: PHI_EPS's top 16
    bits are PHI_TAB_FIRST."""
    return (cl.view(torch.int32) >> 16) - PHI_TAB_FIRST


def phi_table_plain(device=None) -> torch.Tensor:
    """The table as the plain ``phi`` computes it: what the device table
    must equal bit for bit."""
    return phi(phi_table_inputs(device))


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


def make_geometry(C: int, V: int, Dc: int, threads: int) -> Geometry:
    """``threads`` per word on a [C, Dc] graph with V variables, or
    ValueError where the kernel or the card cannot take it."""
    if Dc > MAX_CHK_DEG:
        raise ValueError(f"check degree {Dc} > {MAX_CHK_DEG}: the kernel "
                         "keeps a check row in registers")
    # llr and marg [V], c2v [Dc, C], f32
    return geometry.make_geometry(threads, 4 * (2 * V + Dc * C))


def spa_geometry(C: int, V: int, Dc: int, bf16: bool) -> Geometry:
    """The wrapper's rule: one warp per run of 32 check rows, up to
    ``WORD_WARPS`` warps, or ``WORD_WARPS_MORE`` where the messages are
    f32 or ``WORD_WARPS`` each would leave an SM, by the words its shared
    memory holds, under ``RESIDENT_WARPS``. LDPC(1200,3,6) (24 KB a word, 9
    words an SM) gets 256 threads in bf16 and 384 in f32; margulis (52.8
    KB, 4 words) 384; Hamming(7,4) one warp. Measured on an H100 with
    ``scripts/profile_spa_kernel.py``: on LDPC(1200,3,6) 256 threads beat
    384 by 1.5-2.6% in bf16 and lose by 1.7-2.6% in f32 (15 of 16 pairs
    over eight batches), by 5% on an irregular 1200-bit code in f32 (16 of
    16); on margulis 384 beat 256 by 9%."""
    words = words_per_sm(make_geometry(C, V, Dc, WARP).smem_bytes)
    warps = (WORD_WARPS if bf16 and words * WORD_WARPS >= RESIDENT_WARPS
             else WORD_WARPS_MORE)
    return make_geometry(C, V, Dc, row_threads(C, warps))


def spa_decode_cuda(llr: torch.Tensor, t: BPTables, *, max_iter: int,
                    check_init: bool, msg_dtype: torch.dtype,
                    inf_policy: str, caps: Optional[Sequence[int]] = None,
                    threads: Optional[int] = None) -> tuple:
    """Launch ``csrc/spa_decode.cu`` on the current stream (no sync), at
    the geometry ``spa_geometry`` picks for this graph. ``threads`` forces
    a thread count per word; it is for tests and measurements. Counts
    launches per policy: single-cap in ``spa_decode_cuda.launches``,
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
    bf16 = msg_dtype == torch.bfloat16
    geo = (spa_geometry(C, V, Dc, bf16) if threads is None
           else make_geometry(C, V, Dc, threads))
    for tab in (t.k_chk_var, t.k_var_slot):
        if (tab.device != llr.device or tab.dtype != torch.int32
                or not tab.is_contiguous()):
            raise ValueError("kernel tables must be contiguous int32 on the "
                             "device of llr")
    cap_arr = caps_array(snaps)
    lib = _kernel_library()
    phi_tab = phi_table_cuda(llr.device).data_ptr() if bf16 else None
    B = llr.shape[0]
    x_hats = torch.empty((len(snaps), B, V), dtype=torch.int32,
                         device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    stream = torch.cuda.current_stream(llr.device).cuda_stream
    with torch.cuda.device(llr.device):
        rc = lib.spa_decode_launch(
            llr.data_ptr(), t.k_chk_var.data_ptr(), t.k_var_slot.data_ptr(),
            phi_tab, x_hats.data_ptr(), iters.data_ptr(), B, C, V, Dc, Dv,
            int(max_iter), int(bool(check_init)), int(bf16),
            int(inf_policy == "reference"), cap_arr, len(snaps), geo.threads,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"spa_decode kernel launch failed at {geo.threads} threads and "
            f"{geo.smem_bytes} bytes of shared memory per word: "
            + lib.spa_decode_error_string(rc).decode())
    if caps is None:
        spa_decode_cuda.launches[inf_policy] += 1
        return x_hats[0], iters
    spa_decode_cuda.launches_caps[inf_policy] += 1
    return x_hats, iters


spa_decode_cuda.launches = dict.fromkeys(INF_POLICIES, 0)
spa_decode_cuda.launches_caps = dict.fromkeys(INF_POLICIES, 0)


def phi_table_cuda(device) -> torch.Tensor:
    """The bf16 phi table on a CUDA device, ``PHI_TAB_SIZE`` float32, filled
    by the kernel library's own ``phi`` at first use and kept for the
    process."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the phi table lives on a CUDA device, not {device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _phi_table(index)


@functools.lru_cache(maxsize=None)
def _phi_table(index: int) -> torch.Tensor:
    lib = _kernel_library()
    device = torch.device("cuda", index)
    tab = torch.empty((lib.spa_phi_table_size(),), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        rc = lib.spa_phi_table_fill(
            tab.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError("spa_phi_table_fill launch failed: "
                               + lib.spa_decode_error_string(rc).decode())
        torch.cuda.synchronize(device)      # a fault in the fill raises here
    return tab


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("spa_decode")
    if lib.spa_decode_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.spa_decode_launch.argtypes = ([p] * 6 + [i] * 9
                                          + [ctypes.POINTER(i), i, i, p])
        lib.spa_decode_launch.restype = i
        lib.spa_phi_table_fill.argtypes = [p, p]
        lib.spa_phi_table_fill.restype = i
        lib.spa_phi_table_size.argtypes = []
        lib.spa_phi_table_size.restype = i
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
