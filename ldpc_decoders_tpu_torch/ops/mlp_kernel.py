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
CUDA tensor launches ``csrc/mlp_fused.cu`` or raises. There is no
fallback. The kernel runs every product on the tensor cores in split TF32:
each float32 operand is split into two TF32 values, big = tf32(x) and
small = tf32(x - big), which hold x to 2^-22 of itself, and a multiply-add
is three TF32 products (small * big, big * small, big * big) summed in
float32; the bias, the epilogues and the running gradient sums are IEEE
float32. So the kernel keeps float32 accuracy: the forward within 1e-5 of
the plain version in true float32, the loss and gradients within 1e-5
relative. The two agree within that, not bit for bit. The kernel gives
the same bits on every run (partial gradients per CTA, summed over the
CTAs in a fixed order by a second launch; no float atomics).

The kernel stages every weight in shared memory beside a tile of rows and,
in training, every activation of the tile (its gradient written in place in
the backward) and the CTA's partial gradients. ``mlp_plan`` picks the tile:
the first of ``FORWARD_TILES`` or ``TRAIN_TILES`` whose layout fits the
227 KB a block can have. The last, 8 rows, drops the row strides' padding
against bank conflicts, so that every net an earlier layout took still
fits. A net that does not fit at 8 rows is refused; with two hidden layers
of equal width H and D = 6 that is H > 224 for the forward and H > 158 for
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

FORWARD_TILES = (64, 32, 16, 8)     # rows per tile, tried in this order
TRAIN_TILES = (128, 64, 32, 16, 8)
MAX_LAYERS = 16                 # weight matrices (kMaxLayers)


def _region(n: int) -> int:
    """A region of the layout: its floats rounded up to a multiple of 4."""
    return -(-n // 4) * 4


def _ld_a(n: int, pad: bool) -> int:
    """Row stride of an activation or gradient buffer of n columns
    (``ld_a``): n rounded up to 8, then, padded, to 8 mod 16."""
    x = -(-n // 8) * 8
    return x if not pad or x % 16 == 8 else x + 8


def _ld_w(n_out: int, pad: bool) -> int:
    """Row stride of a staged weight matrix (``ld_w``): n_out rounded up
    to 8, padded to 4 mod 8."""
    return -(-n_out // 8) * 8 + (4 if pad else 0)


def _ld_g(n_out: int, pad: bool) -> int:
    """Row stride of the CTA's gradients of a layer (``ld_g``)."""
    return _ld_a(n_out, pad) if pad else n_out


def smem_floats(sizes: Sequence[int], tile: int, train: bool) -> int:
    """The kernel's shared memory in floats (``csrc/mlp_fused.cu:
    smem_floats``), each region a multiple of 4 floats: the staged weights
    ([n_in][_ld_w(n_out)]) and biases, then in eval two activation buffers
    of the widest layer; in training every layer's activations, each but
    the output's with a column of 1s beside it, the squared errors, and the
    CTA's gradients (each layer's [n_in + 1][_ld_g(n_out)], b as the last
    row). The strides are padded at tiles of 16 rows or more."""
    pad = tile >= 16
    pairs = list(zip(sizes[:-1], sizes[1:]))
    n = sum(_region(n_in * _ld_w(n_out, pad)) + _region(n_out)
            for n_in, n_out in pairs)
    if not train:
        return n + 2 * _region(tile * _ld_a(max(sizes), pad))
    return (n + sum(_region(tile * _ld_a(w + 1, pad)) for w in sizes[:-1])
            + _region(tile * _ld_a(sizes[-1], pad))
            + _region(tile * sizes[-1])
            + sum(_region((n_in + 1) * _ld_g(n_out, pad))
                  for n_in, n_out in pairs))


def mlp_plan(sizes: Sequence[int], train: bool) -> tuple:
    """(tile rows, shared bytes) for a net of these widths, input first;
    ValueError where not even the smallest tile fits."""
    sizes = [int(s) for s in sizes]
    if not 1 <= len(sizes) - 1 <= MAX_LAYERS or min(sizes) < 1:
        raise ValueError(f"the fused MLP takes 1 to {MAX_LAYERS} layers of "
                         f"width >= 1, got widths {sizes}")
    tiles = TRAIN_TILES if train else FORWARD_TILES
    for tile in tiles:
        smem = 4 * smem_floats(sizes, tile, train)
        if smem <= SMEM_PER_CTA:
            return tile, smem
    raise ValueError(
        f"MLP widths {sizes} too wide for the fused MLP kernel "
        f"({'train' if train else 'forward'}): at its smallest row tile, "
        f"{tiles[-1]} rows, the staged weights"
        + (", activations and partial gradients" if train
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
