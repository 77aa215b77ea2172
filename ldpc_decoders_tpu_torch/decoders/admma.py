"""ADMMA: ADMM LP decoding with a learned parity-polytope projection
(counterpart of ``ldpc_decoders_tpu.decoders.admma``).

An MLP (relu hidden layers, sigmoid output) approximates the exact
projection of one check row for a fixed regular check degree. It is
trained offline from random rows (``train_offline``, the CLI below), or
online during decoding with the exact projection as the teacher, and kept
in ``<cache_dir>/model_<dim>-<h...>-<dim>.npz`` under the JAX package's
keys ``w{i}`` [n_in, n_out] and ``b{i}`` [n_out]: a checkpoint written by
either package loads in the other.

``ADMMADecoder.decode`` runs the port's one ADMM loop
(``ops/admm_kernel.py:admm_loop``) with its z-update replaced:

- ``train=True``: the exact projection of every row; one Adam step on
  mean((mlp(rows) - target)^2) over the rows of every word, frozen ones
  included, and the decode goes on with the target. So train mode decodes
  exactly as ``ADMMDecoder`` does: on the CPU as its plain version, on a
  card as ``csrc/admm_decode.cu``, which equals that plain version bit for
  bit;
- ``apprx`` > 0: the MLP for iterations 0..apprx inclusive, the exact
  projection after them;
- otherwise the MLP.

The loop stops when every word is done or at the cap, so it takes one
Adam step per loop iteration, as the JAX package's ``while_loop`` does.

On a card every part of an iteration is a hand-written kernel
(``ops/admm_step.py``, ``ops/mlp_kernel.py``): the x-update and the rows
v (``csrc/admm_step.cu`` K1), the exact projection (K2, ``project_rows``),
the MLP's forward, or its forward, loss and gradients
(``csrc/mlp_fused.cu`` K4), the dual update, norms, freeze and count of
the words left (K3). Only ``torch.optim.Adam``'s update of the parameters,
the host's stop test (one 4-byte read an iteration) and, under a mesh, the
gradients' all-reduce stay PyTorch. On the CPU every part is its plain
version. The JAX package runs ADMMA in XLA: it has no Pallas kernel.

Under a mesh (``set_mesh``, which the harness calls) training is data
parallel over its ``batch`` axis, as the JAX package's ``pmean`` / ``pmin``
make it: each rank's loss is the mean over its own rows, the gradients are
summed over the axis between the gradient pass and ``step()`` and divided
by the ranks, and the loop stops when every word of every rank is done, so
every rank takes the same Adam steps and the replicated MLPs stay equal bit
for bit. Only rank 0 writes a checkpoint.

The MLP keeps float32 accuracy: nothing in the package enables TF32 for
PyTorch's products, so the plain version runs in true float32, and the
fused kernel runs its products on the tensor cores in split TF32 (each
operand as two TF32 values, three TF32 products a multiply-add, summed in
float32), within 1e-5 of the plain version.

Usage (offline trainer):
    python -m ldpc_decoders_tpu_torch.decoders.admma 6 --layers 100 100 \\
        --steps 10000 --batch 1024 --cache_dir cache [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ldpc_decoders_tpu_torch.ops.admm_step import (
    admm_decode_steps,
    project_rows,
)
from ldpc_decoders_tpu_torch.ops.graph import TannerGraph, bp_tables
from ldpc_decoders_tpu_torch.ops.mlp_kernel import (
    mlp_forward,
    mlp_forward_plain,
    mlp_train,
)
from ldpc_decoders_tpu_torch.parallel.mesh import is_coordinator
from ldpc_decoders_tpu_torch.utils.math import pseudo_to_cw_tensor


# ----------------------------------------------------------------------
# The MLP and its checkpoints
# ----------------------------------------------------------------------

class MLP(nn.Module):
    """relu hidden layers and a sigmoid output. Layer i holds ``w{i}``
    [n_in, n_out] and ``b{i}`` [n_out] (the checkpoint's keys, so
    ``state_dict()`` is the npz) and computes ``x @ w + b``."""

    def __init__(self, dim: int, layers: Sequence[int], device=None):
        super().__init__()
        self.sizes = [int(dim)] + [int(h) for h in layers] + [int(dim)]
        for i, (n_in, n_out) in enumerate(zip(self.sizes[:-1],
                                              self.sizes[1:])):
            self.register_parameter(f"w{i}", nn.Parameter(
                torch.zeros((n_in, n_out), device=device)))
            self.register_parameter(f"b{i}", nn.Parameter(
                torch.zeros((n_out,), device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The plain version (``ops/mlp_kernel.py:mlp_forward_plain``),
        which autograd follows."""
        return mlp_forward_plain(list(self.parameters()), x)


def mlp_init(dim: int, layers: Sequence[int], seed: int = 0,
             device=None) -> MLP:
    """Glorot-uniform weights, U(-s, s) with s = sqrt(6 / (n_in + n_out)),
    and zero biases, drawn on the host from a ``torch.Generator`` seeded
    ``seed``: a seed gives the same weights on every device."""
    gen = torch.Generator().manual_seed(int(seed))
    mlp = MLP(dim, layers)
    with torch.no_grad():
        for i, (n_in, n_out) in enumerate(zip(mlp.sizes[:-1],
                                              mlp.sizes[1:])):
            scale = float(np.sqrt(np.float32(6.0 / (n_in + n_out))))
            getattr(mlp, f"w{i}").uniform_(-scale, scale, generator=gen)
    return mlp.to(device)


def params_from_jax(params, device=None) -> MLP:
    """An MLP holding JAX ADMMA parameters: a list of ``{"w", "b"}`` dicts
    of arrays, as the JAX package's ``mlp_init`` / ``load_params`` give
    them (converted with ``np.asarray``)."""
    ws = [np.array(p["w"], np.float32) for p in params]
    mlp = MLP(ws[0].shape[0], [w.shape[1] for w in ws[:-1]])
    with torch.no_grad():
        for i, (w, p) in enumerate(zip(ws, params)):
            getattr(mlp, f"w{i}").copy_(torch.from_numpy(w))
            getattr(mlp, f"b{i}").copy_(torch.from_numpy(
                np.array(p["b"], np.float32)))
    return mlp.to(device)


def params_to_jax(mlp: MLP) -> list:
    """The other way: ``[{"w": ndarray, "b": ndarray}, ...]``."""
    sd = {k: v.detach().cpu().numpy() for k, v in mlp.state_dict().items()}
    return [{"w": sd[f"w{i}"], "b": sd[f"b{i}"]}
            for i in range(len(mlp.sizes) - 1)]


def model_name(dim: int, layers) -> str:
    return "-".join(str(i) for i in [dim] + list(layers) + [dim])


def ckpt_path(cache_dir: str, dim: int, layers) -> str:
    return os.path.join(cache_dir, f"model_{model_name(dim, layers)}.npz")


def save_params(path: str, mlp: MLP) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in mlp.state_dict().items()})


def load_params(path: str, device=None) -> MLP:
    z = np.load(path)
    n = len([k for k in z.files if k.startswith("w")])
    return params_from_jax([{"w": z[f"w{i}"], "b": z[f"b{i}"]}
                            for i in range(n)], device)


def make_adam(mlp: MLP, learning_rate: float) -> torch.optim.Adam:
    """``torch.optim.Adam`` with its defaults (betas 0.9 and 0.999, eps
    1e-8: ``optax.adam``'s) in its for-loop implementation
    (``foreach=False``): one chain of elementwise operations per parameter
    tensor, the same on the CPU and on a card."""
    return torch.optim.Adam(mlp.parameters(), lr=learning_rate,
                            foreach=False)


def adam_step(mlp: MLP, opt: torch.optim.Adam, rows: torch.Tensor,
              target: torch.Tensor, mesh=None) -> torch.Tensor:
    """One step on mean((mlp(rows) - target)^2); returns the loss. The loss
    and gradients come from ``mlp_train`` (the fused kernel on a card,
    autograd on the CPU) and land in ``p.grad``. With a ``mesh`` the
    gradients are averaged over its ``batch`` axis first (one sum of all of
    them, on the main group)."""
    params = list(mlp.parameters())
    loss, grads = mlp_train(params, rows, target)
    for p, g in zip(params, grads):
        p.grad = g
    n = mesh.width("batch") if mesh is not None else 1
    if n > 1:
        flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                               "batch") / n
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
    opt.step()
    return loss.detach()


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------

class ADMMADecoder:
    """Batched ADMM with a learned projection. decode(llr [B, V]) ->
    (x_hat, iters); the MLP and its optimizer live on the graph's device
    and, in train mode, carry their state from one decode() to the next."""

    id_keys = ["mu", "eps", "max_iter", "allow_pseudo", "layers"]
    track_iter_hist = True
    # decode() updates the parameters in train mode: the harness calls it
    # once per chunk, in dispatch order, on this one object.
    stateful = True

    def __init__(self, graph: TannerGraph, mu: float = 3.0, eps: float = 1e-5,
                 max_iter: int = 10, allow_pseudo: bool = False,
                 layers=(100, 100), train: bool = False, apprx: int = -1,
                 cache_dir: Optional[str] = "cache", iter_cap: int = 2000,
                 learning_rate: float = 1e-3, seed: int = 0, device=None,
                 **_):
        if len(graph.chk_degrees) != 1:
            raise ValueError("ADMMA requires a regular check degree")
        self.graph = graph if device is None else graph.to(device)
        self.tables = bp_tables(self.graph)
        self.dim = int(graph.chk_degrees[0])
        self.mu, self.eps = float(mu), float(eps)
        self.max_iter = int(max_iter)
        self.allow_pseudo = bool(allow_pseudo)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.layers = list(layers)
        self.train = bool(train)
        self.switch = int(apprx)
        self.cache_dir = cache_dir or "cache"

        path = ckpt_path(self.cache_dir, self.dim, self.layers)
        if self.train:
            self.mlp = mlp_init(self.dim, self.layers, seed,
                                device=self.graph.device)
        else:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no trained projection model at {path}; run with "
                    "train=True (or the offline trainer) first")
            self.mlp = load_params(path, device=self.graph.device)
        self.opt = make_adam(self.mlp, learning_rate)
        self.mesh = None

    def set_mesh(self, mesh) -> None:
        """Train data-parallel over ``mesh``'s batch axis from now on."""
        self.mesh = mesh

    def save(self) -> str:
        """Write the checkpoint (on rank 0 only) and return its path."""
        path = ckpt_path(self.cache_dir, self.dim, self.layers)
        if is_coordinator():
            save_params(path, self.mlp)
        return path

    def _exact(self, v: torch.Tensor) -> torch.Tensor:
        # The check degree is regular: every row is full, no mask.
        return project_rows(v)

    def _z_update(self, it: int, v: torch.Tensor) -> torch.Tensor:
        """v [B, C, D] -> z [B, C, D] at loop iteration ``it``."""
        if self.train:
            target = self._exact(v)
            adam_step(self.mlp, self.opt, v.reshape(-1, self.dim),
                      target.reshape(-1, self.dim), self.mesh)
            return target
        if 0 < self.switch < it:
            return self._exact(v)
        return mlp_forward(list(self.mlp.parameters()),
                           v.reshape(-1, self.dim)).reshape(v.shape)

    def _all_done(self, left: torch.Tensor) -> bool:
        if self.train and self.mesh is not None:
            return self.mesh.all_true(left == 0, "batch")
        return int(left) == 0

    def decode(self, llr: torch.Tensor) -> tuple:
        x_hat, iters, x = admm_decode_steps(
            llr.to(torch.float32).contiguous(), self.tables, mu=self.mu,
            eps=self.eps, max_iter=self.iter_cap, n_edge=self.graph.n_edge,
            z_update=self._z_update, all_done=self._all_done)
        if self.allow_pseudo:
            return pseudo_to_cw_tensor(x, True), iters
        return x_hat, iters


# ----------------------------------------------------------------------
# Offline trainer
# ----------------------------------------------------------------------

def train_offline(dim: int, layers, steps: int = 10000, batch: int = 1024,
                  cache_dir: str = "cache", learning_rate: float = 1e-3,
                  seed: int = 0, log_every: int = 500,
                  device="cuda") -> tuple:
    """Train the MLP against the exact projection on rows uniform in
    [0, 1)^dim, drawn on ``device`` from a generator seeded ``seed``; save
    the checkpoint and return (mlp, the last step's loss)."""
    device = torch.device(device)
    mlp = mlp_init(dim, list(layers), seed, device=device)
    opt = make_adam(mlp, learning_rate)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    loss = None
    for i in range(steps):
        x = torch.rand((batch, dim), generator=gen, device=device)
        loss = adam_step(mlp, opt, x, project_rows(x))
        if log_every and i % log_every == 0:
            print(f"step {i} loss {float(loss):.6f}")
    save_params(ckpt_path(cache_dir, dim, list(layers)), mlp)
    return mlp, float(loss)


def main(argv=None):
    p = argparse.ArgumentParser(description="offline projection training")
    p.add_argument("dim", type=int)
    p.add_argument("--layers", nargs="+", type=int, default=[100, 100])
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--cache_dir", default="cache")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda or cpu")
    args = p.parse_args(argv)
    _, loss = train_offline(args.dim, args.layers, args.steps, args.batch,
                            args.cache_dir, device=args.device)
    print("final loss", loss)


if __name__ == "__main__":
    main()
