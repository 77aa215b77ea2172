"""Batched incremental peeling of LT fountain codes: the CUDA kernel's
wrapper and its plain PyTorch version.

``lt_peel`` picks the route by the device of its tensors: a CPU tensor runs
``lt_peel_plain``; a CUDA tensor launches the hand-written kernel
``csrc/lt_peel.cu`` or raises. There is no fallback from the kernel to the
plain version. Neither has a Pallas counterpart: the kernel takes the place
of the JAX package's sparse engine (``ldpc_decoders_tpu/fountain/lt.py:
LTSimulator._segment``), which ran as XLA gathers and cumsums.

Inputs, per sim b of a batch (the edge lists ``sample_edges(light=True)``
draws): ``edge_sym`` [B, E] int32, non-decreasing, pads = n; ``edge_var``
[B, E] int32, pads = k; ``msg`` [B, k] int32 bits. Outputs: ``result`` [B]
int32, the symbols the peeling decoder needed (n on failure); ``est`` [B,
k] int32 recovered bits, meaningful where ``resolved`` [B, k] bool is set;
``rounds`` [B] int32: the plain version's whole peel rounds, the kernel's
ripples (one, plus one per prefix jump). Only the first three outputs are
compared.

Semantics (the JAX package's ``_segment``, ``lt.py:290-375``):

- the active prefix ``m`` starts at k;
- success: no unresolved edge has its symbol in the prefix; the result is
  ``m``. Not every variable need be resolved;
- the ripple, the prefix symbols of unresolved degree 1, resolves each one's
  last variable to the symbol's residual bit, and that bit is XORed into
  every symbol holding the variable, beyond the prefix too;
- stuck (no ripple, no success): ``m`` jumps to 1 + the first symbol at or
  past ``m`` of current degree 1; with none the sim fails with result n.

Peeling is confluent, so the fixpoint, and with it the minimal prefix, the
resolved set and the recovered bits, do not depend on the order in which
symbols are peeled, nor on the order of a variable's edges: the plain
version runs whole rounds over tables in a stable order, the kernel a queue
over tables its own counting sort leaves unordered within each variable.

The sorted-segment tables (``edge_layout``: each symbol's edge range, the
permutation to variable order, each variable's range) are the plain
version's, built with PyTorch's sort and bincounts. The kernel builds its
own, per sim, from the light lists, in its own code (``csrc/lt_peel.cu``: a
counting sort by ``edge_var``; its peel needs no symbol offsets, which a
layout-only launch writes where ``edge_sym`` steps up). ``lt_layout_cuda``
returns them, for checks only; nothing on the card route calls a PyTorch
sort, bincount or gather.
"""

from __future__ import annotations

import ctypes

import torch

from ldpc_decoders_tpu_torch.ops._build import load_library
from ldpc_decoders_tpu_torch.ops.geometry import SMEM_PER_CTA

MAX_SYMBOLS = 65535      # the kernel's 16-bit symbol ids and queue counts
# Warps of the kernel's 32 that retire claimed variables (all 32 build the
# layout): the fastest count at the golden configuration, measured with
# scripts/profile_lt_kernel.py.
PEEL_WARPS = 24


def edge_layout(edge_sym: torch.Tensor, edge_var: torch.Tensor, n: int,
                k: int) -> tuple:
    """The plain version's sorted-segment tables of the light edge lists,
    on their device: ``indptr_sym`` [B, n+2] (each symbol's edge range;
    pads in segment n), ``perm_var`` [B, E] int64 (the stable permutation
    to variable order) and ``indptr_var`` [B, k+2], as
    ``sample_edges(light=False)`` builds them on the host. The kernel's own
    tables (``lt_layout_cuda``) are held against these."""
    B = edge_sym.shape[0]
    dev = edge_sym.device

    def indptr(idx, size):
        off = torch.arange(B, device=dev)[:, None] * (size + 1)
        cnt = torch.bincount((idx + off).flatten(), minlength=B * (size + 1))
        ptr = torch.zeros((B, size + 2), dtype=torch.int32, device=dev)
        ptr[:, 1:] = cnt.view(B, size + 1).cumsum(-1)
        return ptr

    perm_var = torch.sort(edge_var, dim=-1, stable=True).indices
    return indptr(edge_sym, n), perm_var, indptr(edge_var, k)


def _check_inputs(edge_sym, edge_var, msg, n):
    if edge_sym.dim() != 2 or edge_var.shape != edge_sym.shape:
        raise ValueError("edge_sym and edge_var must be [B, E] of one shape")
    if msg.dim() != 2 or msg.shape[0] != edge_sym.shape[0]:
        raise ValueError("msg must be [B, k] with the edge lists' B")
    for name, x in (("edge_sym", edge_sym), ("edge_var", edge_var),
                    ("msg", msg)):
        if x.dtype != torch.int32 or x.device != edge_sym.device:
            raise ValueError(f"{name} must be int32 on the device of edge_sym")
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")


def lt_peel_plain(edge_sym: torch.Tensor, edge_var: torch.Tensor,
                  msg: torch.Tensor, n: int, *, seg_iters: int = 64) -> tuple:
    """The plain PyTorch version: whole peel rounds over the [B, E] edge
    lists, every per-symbol and per-variable reduction a cumsum and two
    indptr gathers (``_segment``'s form, a jump a round of its own).
    ``seg_iters`` rounds run between checks of whether every sim is done;
    it changes no result."""
    _check_inputs(edge_sym, edge_var, msg, n)
    B = edge_sym.shape[0]
    k = msg.shape[1]
    dev = edge_sym.device
    ip_s, perm_var, ip_v = edge_layout(edge_sym, edge_var, n, k)
    ip_s, ip_v = ip_s.long(), ip_v.long()
    es, ev = edge_sym.long(), edge_var.long()
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)

    def seg_sum(data, ip, size):
        c = torch.cat([zero, data.long().cumsum(-1)], -1)
        return (c.gather(-1, ip[:, 1:]) - c.gather(-1, ip[:, :-1]))[:, :size]

    def take_pad(arr, idx):
        """arr[b, idx], where index == arr.shape[-1] reads 0."""
        return torch.cat([arr, zero.to(arr.dtype)], -1).gather(-1, idx)

    # A carrier count is at most a variable's degree <= n: pack it with the
    # carried-bit sum in one reduction.
    pack = n + 1
    unres_e = es < n
    rcv = seg_sum(take_pad(msg, ev), ip_s, n) % 2
    resolved = torch.zeros((B, k), dtype=torch.bool, device=dev)
    est = torch.zeros((B, k), dtype=torch.int32, device=dev)
    m = torch.full((B,), k, dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    result = torch.full((B,), n, dtype=torch.int32, device=dev)
    rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
    sym_idx = torch.arange(n, device=dev)
    # Each round resolves a variable, jumps the prefix or ends the sim.
    for it in range(k + n + 2):
        edge_active = unres_e & (es < m[:, None])
        success = ~edge_active.any(-1)
        deg_all = seg_sum(unres_e, ip_s, n)
        ripple = (deg_all == 1) & (sym_idx < m[:, None])
        has_ripple = ripple.any(-1)

        gath = take_pad(torch.where(ripple, rcv + 1, 0), es)
        resolve_edge = edge_active & (gath > 0)
        packed = resolve_edge.long() + torch.where(resolve_edge, gath - 1,
                                                   0) * pack
        sp = seg_sum(packed.gather(-1, perm_var), ip_v, k)
        newly = (sp % pack > 0) & ~resolved
        est_n = torch.where(newly, (sp // pack > 0).to(torch.int32), est)

        g2 = take_pad(torch.where(newly, est_n.long() + 1, 0), ev)
        contrib = seg_sum(torch.where(unres_e & (g2 > 0), g2 - 1, 0), ip_s, n)

        grow = ~done & ~success & ~has_ripple
        nxt = torch.where((deg_all == 1) & (sym_idx >= m[:, None]), sym_idx,
                          n).min(-1).values
        act = ~done
        act2 = act[:, None]
        resolved = torch.where(act2, resolved | newly, resolved)
        est = torch.where(act2, est_n, est)
        rcv = torch.where(act2, (rcv + contrib) % 2, rcv)
        unres_e = torch.where(act2, unres_e & (g2 == 0), unres_e)
        m = torch.where(act & grow & (nxt < n), nxt + 1, m)
        result = torch.where(act & success, m.to(torch.int32), result)
        rounds += act.to(torch.int32)
        done = done | (act & (success | (grow & (nxt >= n))))
        if (it + 1) % seg_iters == 0 and bool(done.all()):
            break
    return result, est, resolved, rounds


def shared_bytes(n: int, k: int, on_chip: bool) -> int:
    """The kernel's dynamic shared memory: 32 bytes of counters, the ripple
    queue (a 32-bit slot per variable it can claim, min(n, k)), the
    resolved and recovered bitmaps of k bits each, and with ``on_chip`` the
    64-bit symbol words and the variable offsets (k + 1 ints)."""
    b = 32 + 4 * min(n, k) + 8 * ((k + 31) // 32)
    if on_chip:
        b += 8 * n + 4 * (k + 1)
    return b


def kernel_plan(edge_sym: torch.Tensor, edge_var: torch.Tensor,
                msg: torch.Tensor, n: int) -> bool:
    """Check what ``csrc/lt_peel.cu`` takes, on any device: raises
    ValueError for inputs or sizes it cannot run, else returns whether the
    symbol words and variable offsets fit in shared memory (else they live
    in device memory). The bitmaps' budget keeps k below 2^20, which the
    symbol words' degree field needs."""
    _check_inputs(edge_sym, edge_var, msg, n)
    k = msg.shape[1]
    if n > MAX_SYMBOLS:
        raise ValueError(f"n = {n} symbols > {MAX_SYMBOLS}: the kernel "
                         "keeps 16-bit symbol ids and 16-bit queue counts")
    smem = shared_bytes(n, k, False)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"k = {k}, n = {n} needs {smem} bytes of shared "
                         f"memory per sim, a CTA has {SMEM_PER_CTA}")
    return shared_bytes(n, k, True) <= SMEM_PER_CTA


def _launch(edge_sym, edge_var, msg, n, peel_warps, layout_only):
    _check_inputs(edge_sym, edge_var, msg, n)
    if not edge_sym.is_cuda:
        raise ValueError("lt_peel_cuda needs CUDA tensors")
    on_chip = kernel_plan(edge_sym, edge_var, msg, n)
    if not 1 <= peel_warps <= 32:
        raise ValueError(f"peel_warps must be in [1, 32], got {peel_warps}")
    B, E = edge_sym.shape
    k = msg.shape[1]
    edge_sym, edge_var, msg = (x.contiguous() for x in (edge_sym, edge_var,
                                                        msg))
    dev = edge_sym.device
    i32 = dict(dtype=torch.int32, device=dev)
    sym_by_var = torch.empty((B, E), dtype=torch.int16, device=dev)
    ip_v = torch.empty((B, k + 2), **i32)
    words = (None if on_chip
             else torch.empty((B, n), dtype=torch.int64, device=dev))
    ip_s = torch.empty((B, n + 2), **i32) if layout_only else None
    result = torch.empty((B,), **i32)
    est = torch.empty((B, k), **i32)
    resolved = torch.empty((B, k), dtype=torch.bool, device=dev)
    rounds = torch.empty((B,), **i32)
    lib = _kernel_library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        rc = lib.lt_peel_launch(
            edge_sym.data_ptr(), edge_var.data_ptr(), msg.data_ptr(),
            sym_by_var.data_ptr(), ptr(words), ip_v.data_ptr(), ptr(ip_s),
            result.data_ptr(), est.data_ptr(), resolved.data_ptr(),
            rounds.data_ptr(), B, E, n, k, int(on_chip), peel_warps,
            int(layout_only), stream)
    if rc != 0:
        raise RuntimeError(f"lt_peel kernel launch failed "
                           f"({shared_bytes(n, k, on_chip)} bytes of shared "
                           "memory per CTA): "
                           + lib.lt_peel_error_string(rc).decode())
    if layout_only:
        return ip_s, sym_by_var.to(torch.int32) & 0xFFFF, ip_v
    return result, est, resolved, rounds


def lt_peel_cuda(edge_sym: torch.Tensor, edge_var: torch.Tensor,
                 msg: torch.Tensor, n: int, *,
                 peel_warps: int = PEEL_WARPS) -> tuple:
    """Launch ``csrc/lt_peel.cu`` on the current stream (no sync): one CTA
    per sim builds its edge layout and runs the whole peel, ``peel_warps``
    of its 32 warps taking ripple symbols. ``rounds`` are the kernel's
    ripples (one, plus one per prefix jump). Counts launches in
    ``lt_peel_cuda.launches``."""
    out = _launch(edge_sym, edge_var, msg, n, peel_warps, False)
    lt_peel_cuda.launches += 1
    return out


lt_peel_cuda.launches = 0


def lt_layout_cuda(edge_sym: torch.Tensor, edge_var: torch.Tensor,
                   msg: torch.Tensor, n: int) -> tuple:
    """The kernel's own edge layout, for checks (not a path of the
    simulator): the same launch stopped before the peel, returning
    ``indptr_sym`` [B, n+2] and ``indptr_var`` [B, k+2] as ``edge_layout``
    gives them, and ``sym_by_var`` [B, E] (the kernel's 16-bit ids as
    int32), each variable's symbols in its range (in an order the
    scatter's atomics chose), the pads after them. Counts launches in
    ``lt_layout_cuda.launches``."""
    out = _launch(edge_sym, edge_var, msg, n, PEEL_WARPS, True)
    lt_layout_cuda.launches += 1
    return out


lt_layout_cuda.launches = 0


def layout_matches(tables: tuple, edge_sym: torch.Tensor,
                   edge_var: torch.Tensor, n: int) -> bool:
    """Whether the kernel's tables (``lt_layout_cuda``) are ``edge_layout``'s:
    both offset tables equal, and each variable's range of ``sym_by_var``
    the same multiset of symbols (``edge_layout``'s ranges are sorted, since
    ``edge_sym`` is)."""
    ip_s, sym_by_var, ip_v = tables
    k = ip_v.shape[1] - 2
    ref_s, perm_var, ref_v = edge_layout(edge_sym, edge_var, n, k)
    if not (torch.equal(ip_s, ref_s) and torch.equal(ip_v, ref_v)):
        return False
    B, E = sym_by_var.shape
    pos = torch.arange(E, dtype=torch.int32,
                       device=ip_v.device).expand(B, E).contiguous()
    seg = torch.searchsorted(ip_v[:, 1:].contiguous(), pos, right=True)
    key = seg.long() * (n + 1) + sym_by_var.long()
    got = (key.sort(-1).values % (n + 1)).to(torch.int32)
    return torch.equal(got, edge_sym.gather(-1, perm_var))


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("lt_peel")
    if lib.lt_peel_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lt_peel_launch.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.lt_peel_launch.restype = i
        lib.lt_peel_error_string.argtypes = [i]
        lib.lt_peel_error_string.restype = ctypes.c_char_p
    return lib


def lt_peel(edge_sym: torch.Tensor, edge_var: torch.Tensor, msg: torch.Tensor,
            n: int, *, seg_iters: int = 64) -> tuple:
    """Route by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if edge_sym.is_cuda:
        return lt_peel_cuda(edge_sym, edge_var, msg, n)
    if edge_sym.device.type == "cpu":
        return lt_peel_plain(edge_sym, edge_var, msg, n, seg_iters=seg_iters)
    raise ValueError(f"no LT peel route for device {edge_sym.device}")
