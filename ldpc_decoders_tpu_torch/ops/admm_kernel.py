"""Whole-loop ADMM LP decode: the CUDA kernel's wrapper and its plain
PyTorch version.

``admm_decode`` picks the route by the device of ``llr``: a CPU tensor
runs ``admm_decode_plain``; a CUDA tensor launches the hand-written kernel
``csrc/admm_decode.cu`` (the port of both ADMM kernels of
``ldpc_decoders_tpu/ops/pallas_bp.py``, ``_admm_kernel`` and
``_admm_kernel_fac``) or raises. There is no fallback from the kernel to
the plain version.

The plain version is one loop, ``admm_loop``, over the two halves of an
iteration split around the z-update (``admm_iter_pre_plain``,
``admm_iter_post_plain``): ADMMA (``decoders/admma.py``) puts its own
z-update between them, and ``ops/admm_step.py`` runs the same loop over the
halves' kernels on a card.

Semantics (the JAX package's ``decoders/admm.py``), per codeword, with
gamma the LLRs, z and lam one value per edge slot and x per variable,
starting from z = 0.5, lam = 0:

- x-update: x = clip((sum over the variable's slots of (z - lam/mu)
  - gamma/mu) / degree, 0, 1), each variable divided by its OWN degree;
- z-update: z_new = the projection of x_e + lam/mu onto the parity
  polytope, per check row, x_e being x gathered to the row's slots
  (``ops/projection.py``; padded slots stay 0);
- dual: lam += mu * (x_e - z_new);
- the word has converged when ||x_e - z_new||^2 < eps^2 * nnz(H) and
  ||z - z_new||^2 < eps^2 * nnz(H); it is then frozen (the converging
  iteration's x, z and lam are kept);
- ``iters`` follows the reference's histogram: a word that converged at
  its k-th update records k - 1, a word stopped by ``max_iter`` records
  ``max_iter``.

The order of the float32 arithmetic is fixed, the same here and in the
kernel, so the two agree bit for bit on the card:

- lam/mu and gamma/mu are products with 1/mu, rounded to float32 once
  (the JAX Pallas kernel's form; its gather route divides by mu instead,
  which costs the CUDA kernel a quarter of its time); every product, sum
  and quotient is rounded on its own (the kernel fuses a multiply with an
  add only where the product is exact: a factor +1, -1 or 0 of the facet
  normal);
- the x-update adds a variable's slots in slot order starting from 0,
  subtracts gamma/mu last, then divides by the degree (the gather route's
  order; the Pallas kernel starts from -gamma/mu);
- each squared norm is summed as: a check row's slots in slot order; then
  the check rows in blocks of 8 consecutive rows (the last block filled up
  with zeros), a block halved with row strides 4, 2, 1; then block b goes
  to lane b mod 32, a lane adding its blocks in ascending order; then the
  32 lanes by halving (strides 16, 8, 4, 2, 1). No thread count enters
  this order, so the kernel may be launched with any number of warps: a
  warp takes 32 consecutive rows at a time, four whole blocks, and sums a
  block with three xor-shuffles.

The launch geometry is the wrapper's own choice, by ``admm_geometry`` from
the graph; callers have no flag for it. ``admm_decode_cuda(threads=...)``
forces a thread count, for tests and measurements; a geometry the card
cannot take raises. The outputs do not depend on it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from ldpc_decoders_tpu_torch.ops import geometry
from ldpc_decoders_tpu_torch.ops._build import load_library
from ldpc_decoders_tpu_torch.ops.geometry import (
    MAX_THREADS,
    WARP,
    WARPS_PER_SM,
    Geometry,
    row_threads,
    words_per_sm,
)
from ldpc_decoders_tpu_torch.ops.graph import BPTables
from ldpc_decoders_tpu_torch.ops.projection import (
    fold_slots,
    project_parity_polytope,
)

ROW_BLOCK = 8           # check rows per block of the norm sums (kRowBlock)
MAX_CHK_DEG = 8         # check rows wider than this are refused (kMaxD)
REGULAR_VAR_DEG = 3     # the kernel's unrolled x-update (kRegularDv)


def _inv_mu(mu: float) -> float:
    """1/mu, rounded to float32 once."""
    return float(np.float32(1.0) / np.float32(mu))


def _threshold(eps: float, n_edge: int) -> float:
    """eps^2 * nnz(H), rounded to float32 once."""
    return float(np.float32(float(eps) ** 2 * int(n_edge)))


def _halve(x: torch.Tensor, width: int) -> torch.Tensor:
    """[..., width] -> [...]: halving with strides width/2, ..., 2, 1."""
    s = width // 2
    while s:
        x = x[..., :s] + x[..., s:2 * s]
        s //= 2
    return x[..., 0]


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    short = -x.shape[-1] % multiple
    if short:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (short,))], dim=-1)
    return x


def word_sum(rows: torch.Tensor) -> torch.Tensor:
    """[B, C] per-check values -> [B], in the fixed order of the module
    docstring (blocks of 8 rows, then 32 lanes of blocks)."""
    B = rows.shape[0]
    blocks = _halve(_pad_to(rows, ROW_BLOCK).reshape(B, -1, ROW_BLOCK),
                    ROW_BLOCK)                                  # [B, nb]
    turns = _pad_to(blocks, WARP).reshape(B, -1, WARP)
    acc = turns[:, 0]
    for r in range(1, turns.shape[1]):
        acc = acc + turns[:, r]
    return _halve(acc, WARP)


def make_geometry(C: int, V: int, Dc: int, threads: int) -> Geometry:
    """``threads`` per word on a [C, Dc] graph, or ValueError where the
    kernel or the card cannot take it."""
    if Dc > MAX_CHK_DEG:
        raise ValueError(f"check degree {Dc} > {MAX_CHK_DEG} (the kernel "
                         "keeps a check row in registers)")
    # z and lam [Dc, C], x [V] and the 2 * ceil(C / 8) block sums, f32
    return geometry.make_geometry(
        threads, 4 * (2 * Dc * C + V + 2 * -(-C // ROW_BLOCK)))


def admm_geometry(C: int, V: int, Dc: int) -> Geometry:
    """The wrapper's rule: one warp per run of 32 check rows, up to 8
    warps, and twice that for as long as the words that fit an SM by
    their shared memory then still fit it by their warps. A word with
    much state leaves an SM few resident words, and more warps each keep
    it busy: margulis (73.5 KB, 3 words per SM) gets 16 warps,
    LDPC(1200,3,6) (33.4 KB, 6 words) 8, Hamming(7,4) its one run of rows.
    Measured on an H100 with ``scripts/sweep_admm_geometry.py``: 16 warps
    take 16% less time than 8 over eight margulis chunks run to
    convergence and no more than 32; 8 take 9% less than 16 on
    LDPC(1200,3,6)."""
    words = words_per_sm(make_geometry(C, V, Dc, WARP).smem_bytes)
    warps = 8
    while 2 * warps * WARP <= MAX_THREADS and \
            2 * warps * words <= WARPS_PER_SM:
        warps *= 2
    return make_geometry(C, V, Dc, row_threads(C, warps))


def admm_iter_pre_plain(z: torch.Tensor, lam: torch.Tensor, g: torch.Tensor,
                        t: BPTables, inv_mu: torch.Tensor) -> tuple:
    """An iteration up to the z-update: z, lam [B, C, Dc], g = gamma/mu
    [B, V] -> (x_new [B, V], x_e [B, C, Dc], v = x_e + lam/mu [B, C, Dc]),
    for every word."""
    B = z.shape[0]
    C, Dc = t.chk_var.shape
    lam_mu = lam * inv_mu
    u = (z - lam_mu).reshape(B, C * Dc)
    acc = torch.zeros_like(g)
    for s in range(t.var_slot.shape[1]):
        acc = acc + torch.where(t.vmask[:, s], u[:, t.var_slot[:, s]], 0.0)
    var_deg = t.vmask.sum(dim=-1).to(torch.float32)
    x_new = ((acc - g) / var_deg).clamp(0.0, 1.0)
    x_e = torch.where(t.cmask, x_new[:, t.chk_var], 0.0)
    return x_new, x_e, x_e + lam_mu


def admm_iter_post_plain(x, z, lam, x_new, x_e, z_new, updates, done,
                         t: BPTables, mu: torch.Tensor,
                         thresh: torch.Tensor) -> tuple:
    """The iteration after the z-update: the dual update, the two squared
    norms, the convergence test and the freeze. Returns the new (x, z,
    lam, updates, done, left), ``left`` the 0-dim count of the words not
    yet done; the inputs are not changed."""
    e1 = x_e - z_new
    e2 = z - z_new
    lam_new = lam + mu * e1
    d1 = word_sum(fold_slots(e1 * e1))
    d2 = word_sum(fold_slots(e2 * e2))
    close = (d1 < thresh) & (d2 < thresh)
    active = ~done
    done = done | (active & close)
    return (torch.where(active[:, None], x_new, x),
            torch.where(active[:, None, None], z_new, z),
            torch.where(active[:, None, None], lam_new, lam),
            updates + active.to(torch.int32), done,
            (~done).sum(dtype=torch.int32))


def admm_loop(llr: torch.Tensor, t: BPTables, *, mu: float, eps: float,
              max_iter: int, n_edge: int, pre: Callable, post: Callable,
              z_update: Callable, all_done: Optional[Callable] = None
              ) -> tuple:
    """The one ADMM loop, over the two halves of an iteration: llr [B, V]
    f32 -> (x_hat [B, V] int32, iters [B] int32, x [B, V] f32, the
    fractional solution). Per iteration ``pre`` (``admm_iter_pre_plain``'s
    signature), ``z_update(it, v)`` (v [B, C, Dc]; ``it`` counts the loop's
    iterations from 0), then ``post`` (``admm_iter_post_plain``'s). The
    state is the plain version's: z, lam [B, C, Dc] row-major, x [B, V],
    words frozen once done. ``all_done(left)``, given the 0-dim count of
    the words not yet done, is the host's stop test (default: none is
    left); data-parallel training makes it global, so every rank runs as
    many iterations. The loop stops when it is true or at ``max_iter``, so
    it runs as many z-updates as the slowest word needs."""
    f32 = torch.float32
    dev = llr.device
    B, V = llr.shape
    C, Dc = t.chk_var.shape
    mu_t = torch.full((), float(mu), dtype=f32, device=dev)
    inv_mu = torch.full((), _inv_mu(mu), dtype=f32, device=dev)
    thresh = torch.full((), _threshold(eps, n_edge), dtype=f32, device=dev)
    g = llr.to(f32) * inv_mu
    z = torch.where(t.cmask, 0.5, 0.0).to(f32).expand(B, C, Dc).contiguous()
    lam = torch.zeros((B, C, Dc), dtype=f32, device=dev)
    x = torch.zeros((B, V), dtype=f32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    updates = torch.zeros(B, dtype=torch.int32, device=dev)
    left = torch.full((), B, dtype=torch.int32, device=dev)
    if all_done is None:
        def all_done(n):
            return int(n) == 0
    it = 0
    while it < max_iter and not all_done(left):
        x_new, x_e, v = pre(z, lam, g, t, inv_mu)
        z_new = z_update(it, v)
        x, z, lam, updates, done, left = post(
            x, z, lam, x_new, x_e, z_new, updates, done, t, mu_t, thresh)
        it += 1
    iters = torch.where(done, updates - 1, updates)
    return (x > 0.5).to(torch.int32), iters, x


def admm_decode_plain(llr: torch.Tensor, t: BPTables, *, mu: float,
                      eps: float, max_iter: int, n_edge: int,
                      z_update: Optional[Callable] = None,
                      all_done: Optional[Callable] = None) -> tuple:
    """The plain PyTorch version: ``admm_loop`` over the plain halves of an
    iteration, batched over [B, C, Dc] tensors, words frozen with
    ``torch.where``. ``z_update(it, v)`` replaces the exact projection of
    the rows v onto the parity polytope (for every word, frozen ones
    included); without it the loop is the kernel's arithmetic, bit for
    bit."""
    if z_update is None:
        def z_update(it, v):
            return project_parity_polytope(v, mask=t.cmask)
    return admm_loop(llr, t, mu=mu, eps=eps, max_iter=max_iter,
                     n_edge=n_edge, pre=admm_iter_pre_plain,
                     post=admm_iter_post_plain, z_update=z_update,
                     all_done=all_done)


def admm_decode_cuda(llr: torch.Tensor, t: BPTables, *, mu: float,
                     eps: float, max_iter: int, n_edge: int,
                     threads: Optional[int] = None) -> tuple:
    """Launch ``csrc/admm_decode.cu`` on the current stream (no sync), at
    the geometry ``admm_geometry`` picks for this graph. ``threads`` forces
    a thread count per word; it is for tests and measurements. Counts
    launches in ``admm_decode_cuda.launches``."""
    if not llr.is_cuda:
        raise ValueError("admm_decode_cuda needs a CUDA tensor")
    if llr.dtype != torch.float32 or llr.dim() != 2 \
            or not llr.is_contiguous():
        raise ValueError("llr must be a contiguous [B, V] float32 tensor")
    Dc, C = t.k_chk_var.shape
    Dv, V = t.k_var_slot.shape
    if llr.shape[1] != V:
        raise ValueError(f"llr has {llr.shape[1]} variables, graph has {V}")
    if max_iter < 0:
        raise ValueError("max_iter must be >= 0")
    for tab in (t.k_chk_var, t.k_var_slot):
        if (tab.device != llr.device or tab.dtype != torch.int32
                or not tab.is_contiguous()):
            raise ValueError("kernel tables must be contiguous int32 on the "
                             "device of llr")
    B = llr.shape[0]
    geo = (admm_geometry(C, V, Dc) if threads is None
           else make_geometry(C, V, Dc, threads))
    lib = _kernel_library()
    x_hat = torch.empty((B, V), dtype=torch.int32, device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    x = torch.empty((B, V), dtype=torch.float32, device=llr.device)
    regular_dv = Dv if (t.chk_full and t.var_full
                        and Dv == REGULAR_VAR_DEG) else 0
    stream = torch.cuda.current_stream(llr.device).cuda_stream
    with torch.cuda.device(llr.device):
        rc = lib.admm_decode_launch(
            llr.data_ptr(), t.k_chk_var.data_ptr(), t.k_var_slot.data_ptr(),
            x_hat.data_ptr(), iters.data_ptr(), x.data_ptr(), B, C, V, Dc,
            Dv, float(mu), _inv_mu(mu), _threshold(eps, n_edge),
            int(max_iter), int(t.chk_full), regular_dv, geo.threads, stream)
    if rc != 0:
        raise RuntimeError(
            f"admm_decode kernel launch failed at {geo.threads} threads and "
            f"{geo.smem_bytes} bytes of shared memory per word: "
            + lib.admm_decode_error_string(rc).decode())
    admm_decode_cuda.launches += 1
    return x_hat, iters, x


admm_decode_cuda.launches = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("admm_decode")
    if lib.admm_decode_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.admm_decode_launch.argtypes = ([p] * 6 + [i] * 5 + [f, f, f]
                                           + [i] * 4 + [p])
        lib.admm_decode_launch.restype = i
        lib.admm_decode_error_string.argtypes = [i]
        lib.admm_decode_error_string.restype = ctypes.c_char_p
    return lib


def admm_decode(llr: torch.Tensor, t: BPTables, *, mu: float, eps: float,
                max_iter: int, n_edge: int) -> tuple:
    """Route by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    kw = dict(mu=mu, eps=eps, max_iter=max_iter, n_edge=n_edge)
    if llr.is_cuda:
        return admm_decode_cuda(llr, t, **kw)
    if llr.device.type == "cpu":
        return admm_decode_plain(llr, t, **kw)
    raise ValueError(f"no ADMM route for device {llr.device}")
