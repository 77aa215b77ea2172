"""The Monte-Carlo chunk's work around its decode: the wrappers of
``csrc/chunk.cu`` and their plain PyTorch versions.

A chunk draws (PyTorch's ``torch.randint`` of the codebook rows for
codeword -1, then the channel's ``draw`` on the runner's generator: the
goldens' z-checks and the exact replays fix those streams), turns the
codeword and the draw into what the decoder takes, decodes, and tallies the
decisions. The two deterministic passes are kernels on the card:

- C1 ``transmit``: the codeword (a constant bit, or ``idx`` [B] rows of the
  codebook ``cb`` [M, V]) and the draw [B, V] -> the LLRs [B, V] float32,
  the channel symbols, or both, in one pass. The plain version is the
  channel module's own ``llr(apply(x, draw, p), p)``; the kernel equals it
  bit for bit, reading the constants ``apply`` and ``llr`` compute (the
  channel module's ``constants``) from the same 0-dim device tensors.
- C2 ``tally``: decisions [B, V] -> the packed int64 ``[wec, bec]`` tally,
  extended by the 2000-bin histogram of ``iters`` (clipped to the last
  bin); or P planes [P, B, V] -> ``[2, P]``, after an optional first column
  (``raw`` symbols tallied as a plane: the cap sweep's label 0 on the BSC
  and BEC; ``all_wrong``: its label 0 on biAWGN, every bit an error). The
  kernel equals the plain version exactly (integer sums).

Each routes by the device of the tensor it is given: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises. There is no
fallback. Launches count in ``transmit_cuda.launches`` and
``tally_cuda.launches``. Neither kernel is built before its first launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ldpc_decoders_tpu_torch.ops._build import load_library

HIST_LEN = 2000         # bins of the iteration histogram (csrc: kHistLen)
CHANNEL_IDS = {"biawgn": 0, "bsc": 1, "bec": 2}
WANTS = ("llr", "sym", "both")


def _channel(channel: str):
    from ldpc_decoders_tpu_torch.channels import CHANNELS

    if channel not in CHANNELS:
        raise ValueError(f"unknown channel {channel!r}")
    return CHANNELS[channel]


def codeword_plane(shape, codeword: int = 0,
                   idx: Optional[torch.Tensor] = None,
                   cb: Optional[torch.Tensor] = None,
                   device=None) -> torch.Tensor:
    """The codewords [B, V] int32: rows ``idx`` of ``cb`` for codeword -1,
    else ``codeword`` everywhere (the plain versions build it; the kernels
    never do)."""
    if codeword == -1:
        if idx is None or cb is None:
            raise ValueError("codeword -1 needs idx and cb")
        return cb[idx].to(torch.int32)
    if codeword not in (0, 1):
        raise ValueError(f"codeword must be 0, 1 or -1, not {codeword}")
    return torch.full(tuple(shape), codeword, dtype=torch.int32,
                      device=device)


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def transmit_plain(channel: str, noise: torch.Tensor, param,
                   codeword: int = 0, idx: Optional[torch.Tensor] = None,
                   cb: Optional[torch.Tensor] = None, want: str = "llr"):
    """C1's plain version: ``mod.llr(mod.apply(x, noise, param), param)``
    of the channel module ``mod``, where ``mod.send`` is ``mod.apply`` of
    its own draw. Returns the LLRs, the symbols (``want="sym"``), or
    (symbols, LLRs)."""
    if want not in WANTS:
        raise ValueError(f"want must be one of {WANTS}")
    mod = _channel(channel)
    x = codeword_plane(noise.shape, codeword, idx, cb, noise.device)
    y = mod.apply(x, noise, param)
    if want == "sym":
        return y
    gamma = mod.llr(y, param)
    return gamma if want == "llr" else (y, gamma)


def tally_plain(x_hat: torch.Tensor, codeword: int = 0,
                idx: Optional[torch.Tensor] = None,
                cb: Optional[torch.Tensor] = None,
                raw: Optional[torch.Tensor] = None, all_wrong: bool = False,
                iters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C2's plain version, the runners' tally: decisions [B, V] -> int64
    ``[wec, bec]`` (+ the ``HIST_LEN``-bin histogram of ``iters``); planes
    [P, B, V] -> int64 ``[2, P]``, after a first column of ``raw`` [B, V]
    symbols or, with ``all_wrong``, of words whose every bit is wrong."""
    _check_tally_args(x_hat, raw, all_wrong, iters)
    planes = x_hat if x_hat.dim() == 3 else x_hat[None]
    x = codeword_plane(planes.shape[1:], codeword, idx, cb, planes.device)
    errs = (planes != x[None]).sum(dim=-1)                  # [P, B]
    if raw is not None:
        errs = torch.cat([(raw != x).sum(dim=-1)[None], errs])
    elif all_wrong:
        errs = torch.cat([torch.full_like(errs[:1], x.shape[-1]), errs])
    tally = torch.stack([(errs > 0).sum(dim=-1), errs.sum(dim=-1)])
    if x_hat.dim() == 3:
        return tally
    tally = tally[:, 0]
    if iters is None:
        return tally
    # index_add_ into a fixed-length vector: torch.bincount would
    # synchronize to size its output.
    bins = iters.clamp(0, HIST_LEN - 1).long()
    hist = torch.zeros(HIST_LEN, dtype=tally.dtype, device=tally.device)
    hist.index_add_(0, bins, torch.ones_like(bins))
    return torch.cat([tally, hist])


def _check_tally_args(x_hat, raw, all_wrong, iters) -> None:
    if x_hat.dim() not in (2, 3):
        raise ValueError("x_hat must be [B, V] or [P, B, V]")
    if (raw is not None or all_wrong) and x_hat.dim() != 3:
        raise ValueError("a first column (raw, all_wrong) needs planes "
                         "[P, B, V]")
    if raw is not None and all_wrong:
        raise ValueError("raw and all_wrong both fill the first column")
    if raw is not None and raw.shape != x_hat.shape[1:]:
        raise ValueError("raw must be one [B, V] plane")
    if iters is not None and (x_hat.dim() != 2
                              or iters.shape != x_hat.shape[:1]):
        raise ValueError("the histogram takes iters [B] of a [B, V] tally")


# ----------------------------------------------------------------------
# Kernels
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _constants(channel: str, param: float, device: torch.device) -> tuple:
    """The channel's constants as its plain code computes them: the same
    0-dim device tensors, made once per sweep point and device (a chunk
    then reads them without a launch or a host round trip)."""
    return _channel(channel).constants(param, device)


def _vec(V: int, *ts) -> int:
    """4 where every row is a multiple of 4 wide and every tensor starts
    16-byte aligned (16-byte loads and stores), else 1."""
    ok = V % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in ts)
    return 4 if ok else 1


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _on_card(what: str, dev: torch.device, *ts) -> None:
    for t in ts:
        if t is not None and (not t.is_cuda or t.device != dev):
            raise ValueError(f"{what} needs CUDA tensors on one device")


def _codebook(idx, cb, dev):
    if idx is None or cb is None:
        raise ValueError("codeword -1 needs idx and cb")
    _on_card("codeword -1", dev, idx, cb)
    if idx.dtype != torch.int64 or cb.dtype != torch.int32 \
            or not cb.is_contiguous() or idx.dim() != 1 or cb.dim() != 2:
        raise ValueError("codeword -1 needs idx [B] int64 and a contiguous "
                         "cb [M, V] int32")
    return idx.contiguous()


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _kernel_library().chunk_error_string(rc)
                           .decode())


def transmit_cuda(channel: str, noise: torch.Tensor, param,
                  codeword: int = 0, idx: Optional[torch.Tensor] = None,
                  cb: Optional[torch.Tensor] = None, want: str = "llr",
                  out: Optional[torch.Tensor] = None):
    """C1 on the current stream (no sync). ``noise`` [B, V] float32 is the
    channel's draw; ``out`` (``want`` "llr" or "sym") is written in place
    of a new tensor. Returns what ``transmit_plain`` returns. Counts
    launches in ``transmit_cuda.launches``."""
    if want not in WANTS:
        raise ValueError(f"want must be one of {WANTS}")
    if channel not in CHANNEL_IDS:
        raise ValueError(f"unknown channel {channel!r}")
    if (not noise.is_cuda or noise.dtype != torch.float32
            or noise.dim() != 2 or not noise.is_contiguous()):
        raise ValueError("transmit needs the draw as a contiguous [B, V] "
                         "float32 CUDA tensor")
    dev = noise.device
    B, V = noise.shape
    if codeword == -1:
        idx = _codebook(idx, cb, dev)
        if idx.shape[0] != B or cb.shape[1] != V:
            raise ValueError(f"idx must be [{B}] and cb [M, {V}]")
    elif codeword in (0, 1):
        idx = cb = None
    else:
        raise ValueError(f"codeword must be 0, 1 or -1, not {codeword}")
    sym_dtype = torch.float32 if channel == "biawgn" else torch.int32
    if out is not None:
        if want == "both":
            raise ValueError("out takes one output: want 'llr' or 'sym'")
        want_dtype = torch.float32 if want == "llr" else sym_dtype
        if (out.shape != (B, V) or out.dtype != want_dtype
                or not out.is_contiguous() or out.device != dev):
            raise ValueError(f"out must be a contiguous [{B}, {V}] "
                             f"{want_dtype} tensor on {dev}")

    def output(kind, dtype):
        if want == kind and out is not None:
            return out
        if want in (kind, "both"):
            return torch.empty((B, V), dtype=dtype, device=dev)
        return None

    gamma = output("llr", torch.float32)
    sym = output("sym", sym_dtype)
    consts = _constants(channel, float(param), dev)
    a = consts[0] if consts else None
    b = consts[1] if len(consts) > 1 else None
    if noise.numel():
        with torch.cuda.device(dev):
            rc = _kernel_library().chunk_transmit_launch(
                CHANNEL_IDS[channel], noise.data_ptr(), max(codeword, 0),
                None if idx is None else idx.data_ptr(),
                None if cb is None else cb.data_ptr(),
                None if a is None else a.data_ptr(),
                None if b is None else b.data_ptr(), float(param),
                None if gamma is None else gamma.data_ptr(),
                None if sym is None else sym.data_ptr(), B * V, V,
                _vec(V, noise, cb, gamma, sym), _stream(noise))
        _raise(rc, "transmit")
        transmit_cuda.launches += 1
    if want == "llr":
        return gamma
    return sym if want == "sym" else (sym, gamma)


transmit_cuda.launches = 0


def tally_cuda(x_hat: torch.Tensor, codeword: int = 0,
               idx: Optional[torch.Tensor] = None,
               cb: Optional[torch.Tensor] = None,
               raw: Optional[torch.Tensor] = None, all_wrong: bool = False,
               iters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C2 on the current stream (no sync): what ``tally_plain`` returns,
    int64 on x_hat's device. ``x_hat`` int32 (or float32: ADMM's
    pseudo-codewords, with no ``raw``), ``raw`` int32, ``iters`` int32.
    Counts launches in ``tally_cuda.launches``."""
    _check_tally_args(x_hat, raw, all_wrong, iters)
    if not x_hat.is_cuda or x_hat.dtype not in (torch.int32, torch.float32):
        raise ValueError("tally needs int32 or float32 CUDA decisions")
    dev = x_hat.device
    _on_card("tally", dev, raw, iters)
    is_float = x_hat.dtype == torch.float32
    if raw is not None and (raw.dtype != torch.int32 or is_float):
        raise ValueError("raw must be int32, beside int32 decisions")
    if iters is not None and iters.dtype != torch.int32:
        raise ValueError("iters must be int32")
    planes = (x_hat if x_hat.dim() == 3 else x_hat[None]).contiguous()
    P, B, V = planes.shape
    if codeword == -1:
        idx = _codebook(idx, cb, dev)
        if idx.shape[0] != B or cb.shape[1] != V:
            raise ValueError(f"idx must be [{B}] and cb [M, {V}]")
    elif codeword in (0, 1):
        idx = cb = None
    else:
        raise ValueError(f"codeword must be 0, 1 or -1, not {codeword}")
    raw = None if raw is None else raw.contiguous()
    iters = None if iters is None else iters.contiguous()
    cols = P + (raw is not None or all_wrong)
    out = torch.empty(2 * cols + (HIST_LEN if iters is not None else 0),
                      dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel_library().chunk_tally_launch(
            planes.data_ptr(), int(is_float),
            None if raw is None else raw.data_ptr(), int(all_wrong),
            max(codeword, 0), None if idx is None else idx.data_ptr(),
            None if cb is None else cb.data_ptr(),
            None if iters is None else iters.data_ptr(), B, V, P,
            _vec(V, planes, raw, cb), out.data_ptr(), _stream(planes))
    _raise(rc, "tally")
    tally_cuda.launches += 1
    if x_hat.dim() == 3:
        return out.view(2, cols)
    return out


tally_cuda.launches = 0


def _kernel_library() -> ctypes.CDLL:
    lib = load_library("chunk")
    if lib.chunk_transmit_launch.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        lib.chunk_transmit_launch.argtypes = ([i, p, i] + [p] * 4 + [f]
                                              + [p, p, ll, i, i, p])
        lib.chunk_transmit_launch.restype = i
        lib.chunk_tally_launch.argtypes = ([p, i, p, i, i, p, p, p]
                                           + [i] * 4 + [p, p])
        lib.chunk_tally_launch.restype = i
        lib.chunk_error_string.argtypes = [i]
        lib.chunk_error_string.restype = ctypes.c_char_p
    return lib


# ----------------------------------------------------------------------
# Routes
# ----------------------------------------------------------------------

def transmit(channel: str, noise: torch.Tensor, param, codeword: int = 0,
             idx: Optional[torch.Tensor] = None,
             cb: Optional[torch.Tensor] = None, want: str = "llr",
             out: Optional[torch.Tensor] = None):
    """Route by the draw's device: CPU -> ``transmit_plain`` (``out``, if
    given, receives a copy), CUDA -> C1 (or raise)."""
    if noise.is_cuda:
        return transmit_cuda(channel, noise, param, codeword, idx, cb, want,
                             out)
    if noise.device.type != "cpu":
        raise ValueError(f"no transmit route for device {noise.device}")
    res = transmit_plain(channel, noise, param, codeword, idx, cb, want)
    if out is None:
        return res
    if want == "both":
        raise ValueError("out takes one output: want 'llr' or 'sym'")
    return out.copy_(res)


def tally(x_hat: torch.Tensor, codeword: int = 0,
          idx: Optional[torch.Tensor] = None,
          cb: Optional[torch.Tensor] = None,
          raw: Optional[torch.Tensor] = None, all_wrong: bool = False,
          iters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Route by the decisions' device: CPU -> ``tally_plain``, CUDA -> C2
    (or raise)."""
    if x_hat.is_cuda:
        return tally_cuda(x_hat, codeword, idx, cb, raw, all_wrong, iters)
    if x_hat.device.type != "cpu":
        raise ValueError(f"no tally route for device {x_hat.device}")
    return tally_plain(x_hat, codeword, idx, cb, raw, all_wrong, iters)
