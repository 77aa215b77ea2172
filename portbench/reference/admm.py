"""Plain ADMM LP decoding, the arithmetic the program states for its ADMM
decode (its CUDA kernel and its plain version agree bit for bit), per word,
with gamma the LLRs, z and lam one value per check slot, x per variable,
from z = 0.5 on real slots, lam = 0:

- x-update: x = clip((the variable's (z - lam/mu) added in slot order from
  0, minus gamma/mu) / its degree, 0, 1), where lam/mu and gamma/mu are
  products with 1/mu rounded to float32 once;
- z_new = the projection of v = x_e + lam/mu onto the parity polytope, row
  by row (``project``; padded slots stay 0);
- lam += mu * (x_e - z_new);
- the squared norms of x_e - z_new and of z - z_new, each summed over a
  row's slots in slot order, then over rows in blocks of 8 (halved with
  strides 4, 2, 1), block b into lane b mod 32 in ascending order, the 32
  lanes halved (``word_sum``); the word is done, and frozen with this
  iteration's state, once both are below eps^2 * nnz(H) (rounded to
  float32);
- iters: k - 1 for a word done at its k-th update, the cap otherwise;
  x_hat = x > 0.5.

Words are independent, so the loop drops done words from its batch as it
goes. ``x_dtype`` rounds the x-update's output, the solution plane (the
control passes bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.codes import Tables

F32 = torch.float32
ROW_BLOCK = 8
LANES = 32


def fold(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for d in range(1, x.shape[-1]):
        acc = acc + x[..., d]
    return acc


def _halve(x: torch.Tensor) -> torch.Tensor:
    s = x.shape[-1] // 2
    while s:
        x = x[..., :s] + x[..., s:2 * s]
        s //= 2
    return x[..., 0]


def _pad(x: torch.Tensor, m: int) -> torch.Tensor:
    short = -x.shape[-1] % m
    if short:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (short,))], dim=-1)
    return x


def word_sum(rows: torch.Tensor) -> torch.Tensor:
    B = rows.shape[0]
    blocks = _halve(_pad(rows, ROW_BLOCK).reshape(B, -1, ROW_BLOCK))
    lanes = _pad(blocks, LANES).reshape(B, -1, LANES)
    acc = lanes[:, 0]
    for r in range(1, lanes.shape[1]):
        acc = acc + lanes[:, r]
    return _halve(acc)


def project(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rows v [..., D] onto the parity polytope of their real slots: cube
    clip; r = the even floor of the clipped sum; the facet normal f is +1
    on the r + 1 largest coordinates (ties by index) and -1 elsewhere; a
    row with f.z <= r keeps the clip, else it is clip(v - beta f, 0, 1)
    with f.clip(v - beta f) = r, beta interpolated between the nearest
    breakpoints (2D candidates and 0) that bracket r."""
    D = v.shape[-1]
    pad = -((v.abs() * mask).amax(dim=-1, keepdim=True) + 4.0)
    v = torch.where(mask, v, pad)
    idx = torch.arange(D, device=v.device)
    a, b = v[..., None, :], v[..., :, None]
    above = (a > b) | ((a == b) & (idx[None, :] < idx[:, None]))
    rank = above.sum(dim=-1).to(v.dtype)
    z = v.clamp(0.0, 1.0)
    s = torch.floor(fold(z))
    r = s - torch.remainder(s, 2.0)
    f = torch.where(rank <= r[..., None], 1.0, -1.0).to(v.dtype)
    fz = fold(f * z)
    inside = fz <= r
    top = f > 0
    cand = torch.cat([torch.where(top, v - 1.0, -v),
                      torch.where(top, v, 1.0 - v)], dim=-1).clamp_min(0.0)
    T = None
    for d in range(D):
        f_d = f[..., d:d + 1]
        term = f_d * (v[..., d:d + 1] - cand * f_d).clamp(0.0, 1.0)
        T = term if T is None else T + term
    cand = torch.cat([cand, torch.zeros_like(cand[..., :1])], dim=-1)
    T = torch.cat([T, fz[..., None]], dim=-1)
    rr = r[..., None]
    inf = torch.full((), float("inf"), dtype=v.dtype, device=v.device)
    lo = torch.where(T >= rr, cand, 0.0).amax(dim=-1)
    hi = torch.where(T <= rr, cand, inf).amin(dim=-1)
    t_lo = torch.where(cand == lo[..., None], T, -inf).amax(dim=-1)
    t_hi = torch.where(cand == hi[..., None], T, inf).amin(dim=-1)
    denom = t_lo - t_hi
    ok = denom > 0
    beta = torch.where(
        ok, lo + (t_lo - r) * (hi - lo) / torch.where(ok, denom, 1.0), lo)
    out = torch.where(inside[..., None], z,
                      (v - beta[..., None] * f).clamp(0.0, 1.0))
    return torch.where(mask, out, 0.0)


def _constants(dev, mu: float, eps: float, n_edge: int) -> tuple:
    mu_t = torch.full((), float(mu), dtype=F32, device=dev)
    inv_mu = torch.full((), float(np.float32(1.0) / np.float32(mu)),
                        dtype=F32, device=dev)
    thresh = torch.full((), float(np.float32(float(eps) ** 2 * n_edge)),
                        dtype=F32, device=dev)
    return mu_t, inv_mu, thresh


def iteration(g, z, lam, t: Tables, var_deg, mu_t, inv_mu, thresh,
              x_dtype=F32) -> tuple:
    """One update of every word in the batch: (x, z_new, lam_new, done)."""
    C, Dc = t.chk_var.shape
    lam_mu = lam * inv_mu
    u = (z - lam_mu).reshape(-1, C * Dc)
    acc = torch.zeros_like(g)
    for s in range(t.var_slot.shape[1]):
        acc = acc + torch.where(t.vmask[:, s], u[:, t.var_slot[:, s]], 0.0)
    x = ((acc - g) / var_deg).clamp(0.0, 1.0).to(x_dtype).to(F32)
    x_e = torch.where(t.cmask, x[:, t.chk_var], 0.0)
    z_new = project(x_e + lam_mu, t.cmask)
    e1 = x_e - z_new
    e2 = z - z_new
    lam_new = lam + mu_t * e1
    d1 = word_sum(fold(e1 * e1))
    d2 = word_sum(fold(e2 * e2))
    return x, z_new, lam_new, (d1 < thresh) & (d2 < thresh)


class _Tail:
    """The last few running words at a fixed batch of ``size`` (padded
    with words already done), their updates under ``torch.where`` so that
    done words keep their state; on a card one update is a CUDA graph,
    replayed without the host's launches in between."""

    def __init__(self, size, g, z, lam, it0, t, consts, var_deg, x_dtype):
        n = g.shape[0]
        dev = g.device
        pad = size - n
        self.t, self.consts, self.var_deg = t, consts, var_deg
        self.x_dtype = x_dtype
        self.g = torch.cat([g, g[:1].expand(pad, -1)])
        self.z = torch.cat([z, z[:1].expand(pad, -1, -1)])
        self.lam = torch.cat([lam, lam[:1].expand(pad, -1, -1)])
        self.x = torch.zeros_like(self.g)
        self.active = torch.arange(size, device=dev) < n
        self.iters = torch.zeros(size, dtype=torch.int32, device=dev)
        self.it = torch.full((), it0, dtype=torch.int32, device=dev)
        self.graph = None
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            state = [b.clone() for b in self._buffers()]
            with torch.cuda.stream(side):
                self._step()                      # warm-up, then restore
            torch.cuda.current_stream(dev).wait_stream(side)
            for b, v in zip(self._buffers(), state):
                b.copy_(v)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._step()

    def _buffers(self):
        return (self.z, self.lam, self.x, self.active, self.iters, self.it)

    def _step(self):
        x, z_new, lam_new, close = iteration(self.g, self.z, self.lam, self.t,
                                             self.var_deg, *self.consts,
                                             x_dtype=self.x_dtype)
        act = self.active
        self.x.copy_(torch.where(act[:, None], x, self.x))
        self.z.copy_(torch.where(act[:, None, None], z_new, self.z))
        self.lam.copy_(torch.where(act[:, None, None], lam_new, self.lam))
        self.it.add_(1)
        self.iters.copy_(torch.where(act & close, self.it - 1, self.iters))
        self.active.copy_(act & ~close)

    def run(self, steps: int) -> None:
        for _ in range(steps):
            if self.graph is None:
                self._step()
            else:
                self.graph.replay()


TAIL_WORDS = 64       # running words from which the loop goes to _Tail
TAIL_CHECK = 64       # tail updates between two looks at the words left


def decode(llr: torch.Tensor, t: Tables, *, mu: float, eps: float,
           max_iter: int, x_dtype: torch.dtype = F32) -> tuple:
    """llr [B, V] float32 -> (x_hat [B, V] int32, iters [B] int32)."""
    dev = llr.device
    B, V = llr.shape
    C, Dc = t.chk_var.shape
    consts = _constants(dev, mu, eps, t.n_edge)
    var_deg = t.vmask.sum(dim=-1).to(F32)
    g = llr.to(F32) * consts[1]
    z = torch.where(t.cmask, 0.5, 0.0).to(F32).expand(B, C, Dc).contiguous()
    lam = torch.zeros((B, C, Dc), dtype=F32, device=dev)
    x_out = torch.zeros((B, V), dtype=F32, device=dev)
    it_out = torch.full((B,), max_iter, dtype=torch.int32, device=dev)
    live = torch.arange(B, device=dev)
    it = 0
    while it < max_iter and live.numel() > TAIL_WORDS:
        it += 1
        x, z, lam_new, done = iteration(g, z, lam, t, var_deg, *consts,
                                        x_dtype=x_dtype)
        x_out[live] = x
        it_out[live[done]] = it - 1
        keep = (~done).nonzero().squeeze(1)
        if keep.numel() < live.numel():
            live, g, z, lam = live[keep], g[keep], z[keep], lam_new[keep]
        else:
            lam = lam_new
    if it < max_iter and live.numel():
        tail = _Tail(TAIL_WORDS, g, z, lam, it, t, consts, var_deg, x_dtype)
        while it < max_iter and bool(tail.active.any()):
            steps = min(TAIL_CHECK, max_iter - it)
            tail.run(steps)
            it += steps
        n = live.numel()
        x_out[live] = tail.x[:n]
        done = ~tail.active[:n]
        it_out[live[done]] = tail.iters[:n][done]
    return (x_out > 0.5).to(torch.int32), it_out
