"""ADMM's loop iteration split around the z-update, on the card: the
wrappers of ``csrc/admm_step.cu`` and the route ADMMA decodes through.

ADMMA's z-update (a learned projection, or the exact one plus an Adam step
on the MLP) leaves the loop at every iteration, so the whole-loop kernel
``csrc/admm_decode.cu`` cannot serve it. Here one iteration of that kernel
(``_admm_core``'s loop body, ``ldpc_decoders_tpu/ops/pallas_bp.py:1219``)
is three kernels, each the port of a plain step:

- K1 ``admm_iter_pre_cuda`` = ``admm_kernel.admm_iter_pre_plain``: the
  x-update and the rows v = x_e + lam/mu, for every word;
- K2 ``project_rows_cuda`` = ``projection.project_parity_polytope``: the
  exact projection of [..., D] rows, D <= 8;
- K3 ``admm_iter_post_cuda`` = ``admm_kernel.admm_iter_post_plain``: the
  dual update, the norms, the convergence test, the freeze, and the count
  of the words not yet done, which the host's stop test reads.

Each equals its plain version bit for bit on the card. ``admm_decode_steps``
runs ``admm_kernel.admm_loop``, the one loop, over K1 and K3 on a CUDA
tensor and over the plain halves on a CPU tensor; ``project_rows`` routes
the projection the same way. There is no fallback: a CUDA tensor launches
the kernels or raises.

The state keeps the plain version's layout, z, lam and v [B, C, Dc]
row-major, so v is the MLP's [B*C, Dc] rows as it lies. K3 updates x, z,
lam, updates and done in place (the plain version returns new tensors):
no second copy of the state is made per iteration. It touches the running
words only (the plain version leaves a frozen word as it was and does not
count it), moving units of ``post_plan``'s rows through shared memory by
bulk copies, so z, z_new and lam must start 16-byte aligned, as fresh
tensors do.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from ldpc_decoders_tpu_torch.ops._build import load_library
from ldpc_decoders_tpu_torch.ops.admm_kernel import (
    MAX_CHK_DEG,
    ROW_BLOCK,
    _inv_mu,
    _threshold,
    admm_decode_plain,
    admm_loop,
)
from ldpc_decoders_tpu_torch.ops.geometry import (
    MAX_THREADS,
    SMEM_PER_CTA,
    WARP,
)
from ldpc_decoders_tpu_torch.ops.graph import BPTables
from ldpc_decoders_tpu_torch.ops.projection import project_parity_polytope

STEP_THREADS = 256      # K1: threads per word, fewer on small graphs
POST_STAGES = 2         # K3: units in flight per CTA (kStages)
POST_PLANES = 3         # K3's staged planes: z, z_new, lam (kPlanes)
POST_MAX_ROWS = MAX_THREADS - WARP      # K3: rows per unit beside the producer
POST_ROWS = 256         # K3: the most rows per unit the wrapper plans
POST_STATIC_BYTES = 48  # K3's mbarriers and unit slots


class StepTables(NamedTuple):
    """The tables of K1 and K3, int32 on the graph's device, -1 where a
    slot is padded: ``chk_var`` [C, Dc] the variable of each check slot,
    ``var_slot`` [V, Dv] the flat index c*Dc + d of each variable slot."""
    chk_var: torch.Tensor
    var_slot: torch.Tensor


def step_tables(t: BPTables) -> StepTables:
    return StepTables(
        chk_var=torch.where(t.cmask, t.chk_var, -1).to(torch.int32)
        .contiguous(),
        var_slot=torch.where(t.vmask, t.var_slot, -1).to(torch.int32)
        .contiguous())


def step_threads(n: int) -> int:
    """K1's threads per word for a word of ``n`` slots or variables:
    STEP_THREADS, or whole warps enough for ``n`` where that is fewer."""
    return min(STEP_THREADS, max(WARP, -(-n // WARP) * WARP), MAX_THREADS)


class PostPlan(NamedTuple):
    """How K3 runs on a [C, Dc] graph: ``rows`` check rows per unit, whole
    runs of 32, one per consumer thread (a word is ceil(C / rows) units);
    ``plane`` floats per staged plane of a stage, a multiple of 4 with room
    for a unit's slots shifted by up to 3 to keep the bulk copies 16-byte
    aligned; ``smem_bytes`` of the CTA, static part included; ``threads``,
    the rows and the producer warp."""
    rows: int
    plane: int
    smem_bytes: int
    threads: int


def post_plan(C: int, Dc: int, max_rows: int = POST_ROWS) -> PostPlan:
    """K3's plan: the fewest units per word of at most ``max_rows`` rows,
    their runs shared out evenly (C = 600: three units of 224 rows at the
    default; margulis, C = 1320: six). ValueError where the card cannot
    take it. Of 96 to 992 rows, 160 and 224 were fastest on an H100 at
    B=4096 on LDPC(1200,3,6), 608 (the whole word) 7% slower (PERF.md
    PR 15)."""
    if not 1 <= Dc <= MAX_CHK_DEG:
        raise ValueError(f"check row width {Dc} not in 1..{MAX_CHK_DEG}")
    if C < 1 or max_rows % WARP or not WARP <= max_rows <= POST_MAX_ROWS:
        raise ValueError(f"no plan for C={C} at {max_rows} rows per unit")
    runs = -(-C // WARP)
    per_unit = max_rows // WARP
    units = -(-runs // per_unit)
    rows = WARP * -(-runs // units)
    plane = 4 * -(-(rows * Dc + 3) // 4)
    smem = (4 * POST_STAGES * (POST_PLANES * plane + 2 * rows // ROW_BLOCK)
            + POST_STATIC_BYTES)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"K3 needs {smem} bytes of shared memory at "
                         f"{rows} rows of {Dc}; an SM gives a CTA "
                         f"{SMEM_PER_CTA}")
    return PostPlan(rows, plane, smem, rows + WARP)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _f32(*ts) -> None:
    dev = ts[0].device
    for a in ts:
        if (not a.is_cuda or a.device != dev or a.dtype != torch.float32
                or not a.is_contiguous()):
            raise ValueError("the ADMM step kernels need contiguous float32 "
                             "CUDA tensors on one device")


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _kernel_library().admm_step_error_string(rc)
                           .decode())


def admm_iter_pre_cuda(z: torch.Tensor, lam: torch.Tensor, g: torch.Tensor,
                       st: StepTables, inv_mu: float) -> tuple:
    """K1 on the current stream (no sync): (x_new [B, V], v [B, C, Dc]).
    ``inv_mu`` is 1/mu rounded to float32 (``admm_kernel._inv_mu``).
    Counts launches in ``admm_iter_pre_cuda.launches``."""
    _f32(z, lam, g)
    C, Dc = st.chk_var.shape
    V, Dv = st.var_slot.shape
    B = z.shape[0]
    if z.shape != (B, C, Dc) or lam.shape != z.shape or g.shape != (B, V):
        raise ValueError(f"z, lam must be [B, {C}, {Dc}] and g [B, {V}]")
    x_new = torch.empty_like(g)
    v = torch.empty_like(z)
    with torch.cuda.device(z.device):
        rc = _kernel_library().admm_iter_pre_launch(
            z.data_ptr(), lam.data_ptr(), g.data_ptr(),
            st.chk_var.data_ptr(), st.var_slot.data_ptr(), x_new.data_ptr(),
            v.data_ptr(), B, C, V, Dc, Dv, float(inv_mu),
            step_threads(max(V, C * Dc)), _stream(z))
    _raise(rc, "admm_iter_pre")
    admm_iter_pre_cuda.launches += 1
    return x_new, v


admm_iter_pre_cuda.launches = 0


def project_rows_cuda(v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 on the current stream (no sync): the projection of every row of
    v [..., D] onto the parity polytope, D <= 8. ``mask`` [..., D] bool,
    whose shape is that of v's last axes, marks the real slots (padded
    ones project to 0). Counts launches in ``project_rows_cuda.launches``."""
    _f32(v)
    D = v.shape[-1]
    if not 1 <= D <= MAX_CHK_DEG:
        raise ValueError(f"row width {D} not in 1..{MAX_CHK_DEG} (the "
                         "kernel keeps a row in registers)")
    M = 1
    if mask is not None:
        if (mask.dtype != torch.bool or mask.device != v.device
                or mask.dim() > v.dim()
                or tuple(v.shape[v.dim() - mask.dim():]) != tuple(mask.shape)):
            raise ValueError("mask must be a bool tensor on v's device whose "
                             "shape is that of v's last axes")
        mask = mask.contiguous()
        M = mask.numel() // D
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        rc = _kernel_library().project_rows_launch(
            v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), v.numel() // D, D, M, _stream(v))
    _raise(rc, "project_rows")
    project_rows_cuda.launches += 1
    return out


project_rows_cuda.launches = 0


def admm_iter_post_cuda(x, z, lam, x_new, x_e, z_new, updates, done,
                        st: StepTables, mu: float, thresh: float,
                        plan: Optional[PostPlan] = None) -> tuple:
    """K3 on the current stream (no sync): updates x, z, lam, updates and
    done in place and returns them with ``left``, the 0-dim int32 count of
    the words not yet done. ``x_e`` is not read (K3 gathers it from x_new;
    the plain version's signature). ``plan`` forces a launch plan
    (``post_plan``), for tests and measurements. Counts launches in
    ``admm_iter_post_cuda.launches``."""
    _f32(x, z, lam, x_new, z_new)
    C, Dc = st.chk_var.shape
    B, V = x.shape
    if (z.shape != (B, C, Dc) or lam.shape != z.shape
            or z_new.numel() != z.numel() or x_new.shape != x.shape
            or updates.shape != (B,) or updates.dtype != torch.int32
            or done.shape != (B,) or done.dtype != torch.bool):
        raise ValueError("admm_iter_post: shapes or types do not match")
    if any(a.data_ptr() % 16 for a in (z, z_new, lam)):
        raise ValueError("admm_iter_post: z, z_new and lam must start "
                         "16-byte aligned (the bulk copies' rule)")
    plan = plan or post_plan(C, Dc)
    counts = torch.empty(2, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernel_library().admm_iter_post_launch(
            x.data_ptr(), z.data_ptr(), lam.data_ptr(), x_new.data_ptr(),
            z_new.data_ptr(), st.chk_var.data_ptr(),
            updates.data_ptr(), done.data_ptr(), counts.data_ptr(), B, C, V,
            Dc, float(mu), float(thresh), plan.rows, plan.plane, _stream(x))
    _raise(rc, "admm_iter_post")
    admm_iter_post_cuda.launches += 1
    return x, z, lam, updates, done, counts[0]


admm_iter_post_cuda.launches = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("admm_step")
    if lib.admm_iter_pre_launch.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.admm_iter_pre_launch.argtypes = [p] * 7 + [i] * 5 + [f, i, p]
        lib.admm_iter_pre_launch.restype = i
        lib.project_rows_launch.argtypes = [p, p, p, ll, i, i, p]
        lib.project_rows_launch.restype = i
        lib.admm_iter_post_launch.argtypes = ([p] * 9 + [i] * 4 + [f, f]
                                              + [i, i, p])
        lib.admm_iter_post_launch.restype = i
        lib.admm_step_error_string.argtypes = [i]
        lib.admm_step_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------------
# Routes
# ----------------------------------------------------------------------

def project_rows(v: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Route by device: CPU -> ``project_parity_polytope``, CUDA -> K2 (or
    raise)."""
    if v.is_cuda:
        return project_rows_cuda(v, mask)
    if v.device.type == "cpu":
        return project_parity_polytope(v, mask=mask)
    raise ValueError(f"no projection route for device {v.device}")


def admm_decode_steps(llr: torch.Tensor, t: BPTables, *, mu: float,
                      eps: float, max_iter: int, n_edge: int,
                      z_update: Callable,
                      all_done: Optional[Callable] = None) -> tuple:
    """ADMM with the z-update ``z_update(it, v)`` (v [B, C, Dc]) in the
    loop, routed by device: a CPU tensor runs ``admm_decode_plain``, a
    CUDA tensor ``admm_loop`` over K1 and K3. Same outputs as
    ``admm_decode_plain``."""
    kw = dict(mu=mu, eps=eps, max_iter=max_iter, n_edge=n_edge,
              z_update=z_update, all_done=all_done)
    if llr.device.type == "cpu":
        return admm_decode_plain(llr, t, **kw)
    if not llr.is_cuda:
        raise ValueError(f"no ADMM route for device {llr.device}")
    st = step_tables(t)
    # The kernels take the loop's constants as host floats: reading the
    # loop's 0-dim device tensors would wait on the card every iteration.
    inv_mu, thresh = _inv_mu(mu), _threshold(eps, n_edge)

    def pre(z, lam, g, _t, _inv_mu):
        x_new, v = admm_iter_pre_cuda(z, lam, g, st, inv_mu)
        return x_new, None, v

    def post(x, z, lam, x_new, x_e, z_new, updates, done, _t, _mu, _thresh):
        return admm_iter_post_cuda(x, z, lam, x_new, x_e, z_new, updates,
                                   done, st, mu, thresh)

    return admm_loop(llr, t, pre=pre, post=post, **kw)
