"""ADMMA's MLP as one fused kernel: its wrappers and its plain PyTorch
version.

The MLP (``decoders/admma.py``) has relu hidden layers and a sigmoid
output; layer i computes ``x @ w{i} + b{i}`` with ``w{i}`` [n_in, n_out].
Its parameters are passed as the list ``[w0, b0, w1, b1, ...]``
(``MLP.parameters()``'s order), read where they lie: no copy is made.

- ``mlp_forward(params, x)``: rows [R, D] -> the MLP's output [R, D];
- ``mlp_train(params, x, target)``: the loss mean((mlp(x) - target)^2)
  and its gradients with respect to every parameter, in the parameters'
  order and shapes.

Both pick the route by the device of ``x``: a CPU tensor runs the plain
version (the MLP's forward, and autograd's backward for the gradients); a
CUDA tensor launches ``csrc/mlp_fused.cu`` (true float32 FFMA, no TF32, no
tensor cores; every activation stays in shared memory) or raises. There
is no fallback. The kernel and the plain version agree within float32
rounding, not bit for bit: their sums run in other orders. The kernel gives
the same bits on every run (partial gradients per CTA, summed over the
CTAs in a fixed order by a second launch; no float atomics).

The kernel stages every weight in shared memory beside a tile of rows and,
in training, every activation and gradient of the tile and the CTA's
partial gradients. ``mlp_plan`` picks the tile: the largest of
``TILE_ROWS`` whose layout fits the 227 KB a block can have. A net that does
not fit at 8 rows is refused; with two hidden layers of
equal width H and D = 6 that is H > 213 for the forward and H > 147 for
training.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from ldpc_decoders_tpu_torch.ops._build import load_library
from ldpc_decoders_tpu_torch.ops.geometry import SMEM_PER_CTA

TILE_ROWS = (64, 32, 16, 8)     # tried in this order
MAX_LAYERS = 16                 # weight matrices (kMaxLayers)


def _region(n: int) -> int:
    """A region of the layout: its floats rounded up to a multiple of 4."""
    return -(-n // 4) * 4


def smem_floats(sizes: Sequence[int], tile: int, train: bool) -> int:
    """The kernel's shared memory in floats (``csrc/mlp_fused.cu:
    smem_floats``), each region a multiple of 4 floats: the staged weights
    (rows of a multiple of 16 floats) and biases, then in eval two
    activation buffers of the widest layer; in training every layer's
    activations (each but the output's with a row of 1s), two gradient
    buffers of the widest layer but the input, the squared errors, and the
    CTA's gradients (each layer's w and b in one region). Activation and
    gradient rows hold tile + 4 floats."""
    pairs = list(zip(sizes[:-1], sizes[1:]))
    row = tile + 4
    n = sum(_region(n_in * -(-n_out // 16) * 16) + _region(n_out)
            for n_in, n_out in pairs)
    if not train:
        return n + 2 * _region(row * max(sizes))
    return (n + sum(_region(row * (w + 1)) for w in sizes[:-1])
            + _region(row * sizes[-1]) + 2 * _region(row * max(sizes[1:]))
            + _region(tile * sizes[-1])
            + sum(_region((n_in + 1) * n_out) for n_in, n_out in pairs))


def mlp_plan(sizes: Sequence[int], train: bool) -> tuple:
    """(tile rows, shared bytes) for a net of these widths, input first;
    ValueError where not even 8 rows fit."""
    sizes = [int(s) for s in sizes]
    if not 1 <= len(sizes) - 1 <= MAX_LAYERS or min(sizes) < 1:
        raise ValueError(f"the fused MLP takes 1 to {MAX_LAYERS} layers of "
                         f"width >= 1, got widths {sizes}")
    for tile in TILE_ROWS:
        smem = 4 * smem_floats(sizes, tile, train)
        if smem <= SMEM_PER_CTA:
            return tile, smem
    raise ValueError(
        f"MLP widths {sizes} too wide for the fused MLP kernel "
        f"({'train' if train else 'forward'}): at its smallest row tile, "
        f"{TILE_ROWS[-1]} rows, the staged weights"
        + (", activations, gradients and partial gradients" if train
           else " and activations")
        + f" need {smem} bytes of shared memory, a block has {SMEM_PER_CTA}")


def sizes_of(params: Sequence[torch.Tensor]) -> list:
    """The widths [D, h..., D] of a parameter list [w0, b0, ...]."""
    return [int(params[0].shape[0])] + [int(w.shape[1]) for w in params[0::2]]


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def mlp_forward_plain(params: Sequence[torch.Tensor],
                      x: torch.Tensor) -> torch.Tensor:
    """The MLP's forward in PyTorch (autograd follows it)."""
    ws, bs = params[0::2], params[1::2]
    for w, b in zip(ws[:-1], bs[:-1]):
        x = torch.relu(x @ w + b)
    return torch.sigmoid(x @ ws[-1] + bs[-1])


def mlp_train_plain(params: Sequence[torch.Tensor], x: torch.Tensor,
                    target: torch.Tensor) -> tuple:
    """(loss, gradients) through autograd; ``params`` require grad."""
    with torch.enable_grad():
        loss = torch.mean((mlp_forward_plain(params, x) - target) ** 2)
        grads = torch.autograd.grad(loss, list(params))
    return loss.detach(), list(grads)


# ----------------------------------------------------------------------
# The kernel
# ----------------------------------------------------------------------

def _check(params, x, target=None) -> list:
    if not x.is_cuda:
        raise ValueError("the fused MLP kernel needs CUDA tensors")
    sizes = sizes_of(params)
    for t in [x] + ([target] if target is not None else []):
        if (t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous()
                or t.shape[1] != sizes[0] or t.device != x.device):
            raise ValueError(f"rows must be contiguous [R, {sizes[0]}] "
                             "float32 tensors on one CUDA device")
    if target is not None and target.shape != x.shape:
        raise ValueError("target must have the rows' shape")
    for i, p in enumerate(params):
        want = (sizes[i // 2], sizes[i // 2 + 1]) if i % 2 == 0 \
            else (sizes[i // 2 + 1],)
        if (p.dtype != torch.float32 or tuple(p.shape) != want
                or not p.is_contiguous() or p.device != x.device):
            raise ValueError(f"parameter {i} must be a contiguous float32 "
                             f"tensor of shape {want} on the rows' device")
    return sizes


def _pointers(params, sizes):
    n = len(sizes) - 1
    return ((ctypes.c_int * (n + 1))(*sizes),
            (ctypes.c_void_p * n)(*[w.data_ptr() for w in params[0::2]]),
            (ctypes.c_void_p * n)(*[b.data_ptr() for b in params[1::2]]))


@functools.lru_cache(maxsize=None)
def _grid_limit(device_index: int, train: bool, smem: int) -> int:
    """CTAs of one wave: the SMs times the CTAs an SM holds."""
    lib = _kernel_library()
    with torch.cuda.device(device_index):
        per_sm = lib.mlp_blocks_per_sm(int(train), smem)
        sms = torch.cuda.get_device_properties(device_index) \
            .multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"the fused MLP kernel fits no SM at {smem} bytes "
                           "of shared memory: "
                           + lib.mlp_error_string(-per_sm).decode())
    return per_sm * sms


def _raise(rc: int, what: str, tile: int, smem: int) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed at {tile} rows per tile and {smem} "
            "bytes of shared memory: "
            + _kernel_library().mlp_error_string(rc).decode())


def mlp_forward_cuda(params: Sequence[torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """Launch the forward of ``csrc/mlp_fused.cu`` on the current stream
    (no sync). Counts launches in ``mlp_forward_cuda.launches``."""
    sizes = _check(params, x)
    tile, smem = mlp_plan(sizes, train=False)
    R = x.shape[0]
    out = torch.empty((R, sizes[-1]), dtype=torch.float32, device=x.device)
    grid = max(1, min(-(-R // tile),
                      _grid_limit(x.device.index, False, smem)))
    lib = _kernel_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.mlp_forward_launch(x.data_ptr(), out.data_ptr(), R,
                                    len(sizes) - 1, *_pointers(params, sizes),
                                    tile, smem, grid, stream)
    _raise(rc, "mlp forward", tile, smem)
    mlp_forward_cuda.launches += 1
    return out


mlp_forward_cuda.launches = 0


def mlp_train_cuda(params: Sequence[torch.Tensor], x: torch.Tensor,
                   target: torch.Tensor) -> tuple:
    """Launch the training pass of ``csrc/mlp_fused.cu`` and its sum over
    the CTAs on the current stream (no sync): (loss, gradients), the
    gradients views of one buffer. Counts the pair as one launch in
    ``mlp_train_cuda.launches``."""
    sizes = _check(params, x, target)
    tile, smem = mlp_plan(sizes, train=True)
    R = x.shape[0]
    if R < 1:
        raise ValueError("training needs at least one row")
    numels = [p.numel() for p in params]
    P = sum(numels) + 1
    grid = min(-(-R // tile), _grid_limit(x.device.index, True, smem))
    partial = torch.empty((grid, P), dtype=torch.float32, device=x.device)
    flat = torch.empty(P, dtype=torch.float32, device=x.device)
    n = np.float32(R * sizes[-1])
    lib = _kernel_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.mlp_train_launch(
            x.data_ptr(), target.data_ptr(), partial.data_ptr(),
            flat.data_ptr(), R, len(sizes) - 1, *_pointers(params, sizes),
            tile, smem, grid, P, float(np.float32(2.0) / n), float(n), stream)
    _raise(rc, "mlp train", tile, smem)
    mlp_train_cuda.launches += 1
    grads = [g.view_as(p) for g, p in zip(flat[:-1].split(numels), params)]
    return flat[-1], grads


mlp_train_cuda.launches = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("mlp_fused")
    if lib.mlp_forward_launch.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        ip, pp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(p)
        lib.mlp_forward_launch.argtypes = [p, p, ll, i, ip, pp, pp, i, i, i,
                                           p]
        lib.mlp_forward_launch.restype = i
        lib.mlp_train_launch.argtypes = [p, p, p, p, ll, i, ip, pp, pp, i, i,
                                         i, i, f, f, p]
        lib.mlp_train_launch.restype = i
        lib.mlp_blocks_per_sm.argtypes = [i, i]
        lib.mlp_blocks_per_sm.restype = i
        lib.mlp_error_string.argtypes = [i]
        lib.mlp_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------------
# Routes
# ----------------------------------------------------------------------

def mlp_forward(params: Sequence[torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """Route by device: CPU -> plain version (no autograd), CUDA -> kernel
    (or raise)."""
    if x.is_cuda:
        return mlp_forward_cuda(params, x)
    if x.device.type == "cpu":
        with torch.no_grad():
            return mlp_forward_plain(params, x)
    raise ValueError(f"no MLP route for device {x.device}")


def mlp_train(params: Sequence[torch.Tensor], x: torch.Tensor,
              target: torch.Tensor) -> tuple:
    """Route by device: CPU -> plain version, CUDA -> kernel (or raise)."""
    if x.is_cuda:
        return mlp_train_cuda(params, x, target)
    if x.device.type == "cpu":
        return mlp_train_plain(params, x, target)
    raise ValueError(f"no MLP route for device {x.device}")
