"""The fused MLP kernel (``csrc/mlp_fused.cu``, K4) on one CUDA device,
timed beside an earlier commit's copy of it in one process.

    python scripts/profile_mlp_kernel.py [--parent DIR_OR_REV]
        [--rows 2457600,1024] [--reps 5]

``--parent`` is an unpacked tree of an earlier commit (``git archive``) or,
where this checkout is a git repository, a revision, unpacked from git
into a temporary directory. Its ``ops/mlp_kernel.py`` is loaded beside this
tree's and its ``csrc/mlp_fused.cu`` built by ``nvcc`` into a temporary
directory; both are held to the plain MLP and timed in turns: parent,
change, change, parent, each the best of ``--reps`` launches by CUDA
events after a warm-up.

Inputs: ADMMA's MLP [6, 100, 100, 6] from ``mlp_init``'s seed, rows drawn
from N(0.5, 0.8) with numpy's seed 0, and their exact parity-polytope
projection as the target, as ADMMA trains it. Row counts: 2,457,600
(ADMMA's 4096 words of LDPC(1200,3,6) an iteration) and 1024
(``train_offline``'s batch). Per count: the forward's and the training
pass's ms for each kernel, the plain MLP's, and each kernel's error against
the plain MLP (the forward's max |diff|; the loss's and each gradient's
relative error, the norm of the difference over the plain one's) and
whether a second run gives the same bits. Every line carries the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ldpc_decoders_tpu_torch.decoders.admma import mlp_init  # noqa: E402
from ldpc_decoders_tpu_torch.ops import _build, mlp_kernel  # noqa: E402
from ldpc_decoders_tpu_torch.ops.projection import (  # noqa: E402
    project_parity_polytope,
)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return out[0] if out else torch.cuda.get_device_name(0)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def library_loader(source: str, build_dir: str):
    """A ``load_library`` for one kernel source: ``nvcc`` with the
    package's flags into ``build_dir``, then ``ctypes``."""
    def load_library(_name: str):
        import ctypes

        out = os.path.join(build_dir, os.path.basename(source) + ".so")
        if not os.path.exists(out):
            flags = list(_build.NVCC_FLAGS[:-2]) + ["-I",
                                                    os.path.dirname(source)]
            proc = subprocess.run([_build._nvcc(), *flags, "-o", out,
                                   source], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"nvcc failed on {source}:\n{proc.stderr}")
            regs = [ln for ln in proc.stderr.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"ptxas {source}: " + "; ".join(r.strip() for r in regs),
                  flush=True)
        return ctypes.CDLL(out)
    return load_library


def copy_of(module_path: str, source: str, build_dir: str, name: str):
    """A wrapper module (``ops/mlp_kernel.py`` of some tree) whose library
    is ``source``, built apart from the package's."""
    mod = load_module(module_path, name)
    mod.load_library = library_loader(source, build_dir)
    mod.mlp_forward_cuda.launches = 0
    mod.mlp_train_cuda.launches = 0
    return mod


def parent_tree(spec: str, tmp: str) -> str:
    if os.path.isdir(spec):
        return spec
    tree = os.path.join(tmp, "parent")
    os.makedirs(tree)
    arch = subprocess.run(["git", "-C", ROOT, "archive", spec,
                           "ldpc_decoders_tpu_torch"], capture_output=True,
                          check=True).stdout
    subprocess.run(["tar", "-x", "-C", tree], input=arch, check=True)
    return tree


def timed(fn, reps):
    """Best of ``reps`` single launches by CUDA events, after a warm-up."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def errors(mod, params, x, target, want_out, want_loss, want_grads):
    """The kernel's errors against the plain MLP, and same bits twice."""
    out = mod.mlp_forward_cuda(params, x)
    loss, grads = mod.mlp_train_cuda(params, x, target)
    out2 = mod.mlp_forward_cuda(params, x)
    loss2, grads2 = mod.mlp_train_cuda(params, x, target)
    torch.cuda.synchronize()
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(grads,
                                                           want_grads)]
    same = (torch.equal(out, out2) and torch.equal(loss, loss2)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    return {"forward_max_abs": float((out - want_out).abs().max()),
            "loss_rel": abs(float(loss) - float(want_loss))
            / float(want_loss),
            "grads_rel": max(rel), "same_bits": same}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--rows", default="2457600,1024")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_mlp_kernel.py needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    params = list(mlp_init(6, [100, 100], 0, device=dev).parameters())
    sizes = mlp_kernel.sizes_of(params)

    with tempfile.TemporaryDirectory() as tmp:
        kernels = {"change": mlp_kernel}
        if args.parent:
            tree = parent_tree(args.parent, tmp)
            kernels["parent"] = copy_of(
                os.path.join(tree, "ldpc_decoders_tpu_torch", "ops",
                             "mlp_kernel.py"),
                os.path.join(tree, "ldpc_decoders_tpu_torch", "csrc",
                             "mlp_fused.cu"), tmp, "parent_mlp_kernel")
        for name, mod in kernels.items():
            mod._kernel_library()
            plans = (mod.mlp_plan(sizes, False), mod.mlp_plan(sizes, True))
            print(f"{name}: forward tile {plans[0][0]} ({plans[0][1]} B), "
                  f"train tile {plans[1][0]} ({plans[1][1]} B) | {card}",
                  flush=True)

        for R in (int(r) for r in args.rows.split(",")):
            rng = np.random.default_rng(0)
            x = torch.as_tensor(rng.normal(0.5, 0.8, (R, sizes[0]))
                                .astype(np.float32), device=dev)
            target = project_parity_polytope(x)
            want_out = mlp_kernel.mlp_forward_plain(params, x).detach()
            want_loss, want_grads = mlp_kernel.mlp_train_plain(params, x,
                                                               target)
            for name, mod in kernels.items():
                err = errors(mod, params, x, target, want_out, want_loss,
                             want_grads)
                print(f"check R={R} {name}: {err} | {card}", flush=True)

            ms = {name: {"forward": [], "train": []} for name in kernels}

            def turn(name):
                mod = kernels[name]
                ms[name]["forward"].append(timed(
                    lambda: mod.mlp_forward_cuda(params, x), args.reps))
                ms[name]["train"].append(timed(
                    lambda: mod.mlp_train_cuda(params, x, target),
                    args.reps))

            others = [n for n in kernels if n != "change"]
            for name in others + ["change", "change"] + others:
                turn(name)
            plain = {
                "forward": timed(lambda: mlp_kernel.mlp_forward_plain(
                    params, x), 1),
                "train": timed(lambda: mlp_kernel.mlp_train_plain(
                    params, x, target), 1)}
            for name, t in ms.items():
                print(f"timing R={R} {name}: forward "
                      + " / ".join(f"{v:.4f}" for v in t["forward"])
                      + " ms, train "
                      + " / ".join(f"{v:.4f}" for v in t["train"])
                      + f" ms | {card}", flush=True)
            print(f"timing R={R} plain: forward {plain['forward']:.4f} ms, "
                  f"train {plain['train']:.4f} ms | {card}", flush=True)


if __name__ == "__main__":
    main()
