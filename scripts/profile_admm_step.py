"""K3 of ADMMA's loop (``csrc/admm_step.cu``, ``admm_iter_post``: dual
update, norms, freeze, words left) on one CUDA device, timed beside an
earlier commit's copy in one process.

    python scripts/profile_admm_step.py [--parent DIR_OR_REV]
        [--variants DIR,...] [--rows N,...] [--reps 5]
        [--batch 4096] [--iters 36]

``--parent`` is an unpacked tree of an earlier commit (``git archive``) or,
where this checkout is a git repository, a revision, unpacked from git into
a temporary directory. Its ``ops/admm_step.py`` is loaded beside this
tree's and its ``csrc/admm_step.cu`` built by ``nvcc`` into a temporary
directory. ``--variants`` names more unpacked trees, loaded the same way
and timed beside the parent. ``--rows`` times this tree's K3 under the
launch plans (``ops/admm_step.py:post_plan``) of these most rows per unit,
each as a change of its own; default the wrapper's plan.

Inputs, LDPC(1200,3,6), biAWGN 2.5 dB, the all-ones codeword, noise from
numpy's seed 0, mu 3, eps 1e-5, B = ``--batch``:
  (i) the first iteration's state: z = 0.5, lam = 0, x = 0, no word done;
      x_new and z_new from the plain x-update and projection;
  (ii) the state after ``--iters`` loop iterations of the exact ADMM loop
      (the plain halves and projection of ``admm_decode_plain``, on the
      card), then the next iteration's x_new and z_new. Its share of
      frozen words is printed.
Every kernel is held bit-equal to ``admm_iter_post_plain`` on both inputs
(x, z, lam, updates, done and the count of words left), then timed in
turns: parent and variants, change, change, variants and parent, each the
best of ``--reps`` single launches by CUDA events, the state restored from
a copy and the 50 MB L2 cache flushed before each launch, and the launch
enqueued while the card spins, so that the host's time to launch does
not enter. The bound is the
bytes of the running words over 3.35 TB/s: z, lam read and written, z_new
read, x_new read and x written, and ``done``. Every line carries the
card's name and power limit.
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

from ldpc_decoders_tpu_torch.channels import biawgn  # noqa: E402
from ldpc_decoders_tpu_torch.codes import get_code  # noqa: E402
from ldpc_decoders_tpu_torch.ops import (  # noqa: E402
    _build,
    admm_kernel,
    admm_step,
)
from ldpc_decoders_tpu_torch.ops.graph import bp_tables  # noqa: E402
from ldpc_decoders_tpu_torch.ops.projection import (  # noqa: E402
    project_parity_polytope,
)

HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 2_000_000         # ~1 ms at the card's clock
CODE, SNR, MU, EPS = "1200_3_6_ldpc", 2.5, 3.0, 1e-5


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

        out = os.path.join(build_dir, f"{abs(hash(source))}.so")
        if not os.path.exists(out):
            flags = list(_build.NVCC_FLAGS[:-2]) + ["-I",
                                                    os.path.dirname(source)]
            proc = subprocess.run([_build._nvcc(), *flags, "-o", out,
                                   source], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n"
                                   f"{proc.stderr}")
            regs = [ln.strip() for ln in proc.stderr.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"ptxas {source}: " + "; ".join(regs), flush=True)
        return ctypes.CDLL(out)
    return load_library


def copy_of(tree: str, build_dir: str, name: str):
    """The ``ops/admm_step.py`` of an unpacked tree, its library built from
    that tree's ``csrc/admm_step.cu``."""
    pkg = os.path.join(tree, "ldpc_decoders_tpu_torch")
    mod = load_module(os.path.join(pkg, "ops", "admm_step.py"), name)
    mod.load_library = library_loader(
        os.path.join(pkg, "csrc", "admm_step.cu"), build_dir)
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


def make_inputs(B: int, iters: int, dev) -> tuple:
    """The two K3 inputs, {name: (t, state (x, z, lam, updates, done),
    x_new, x_e, z_new)}, and the convergence threshold."""
    code = get_code(CODE)
    t = bp_tables(code.graph.to(dev))
    C, Dc = t.chk_var.shape
    noise = np.random.default_rng(0).standard_normal(
        (B, code.get_n())).astype(np.float32)
    x = torch.ones((B, code.get_n()), dtype=torch.float32, device=dev)
    std = torch.sqrt(torch.tensor(biawgn.noise_var(SNR), device=dev))
    llr = biawgn.llr(x + std * torch.as_tensor(noise, device=dev), SNR)
    inv_mu = torch.tensor(admm_kernel._inv_mu(MU), device=dev)
    mu_t = torch.tensor(MU, device=dev)
    thresh = torch.tensor(admm_kernel._threshold(EPS, code.graph.n_edge),
                          device=dev)
    g = llr * inv_mu
    state = (torch.zeros_like(g),
             torch.where(t.cmask, 0.5, 0.0).expand(B, C, Dc).contiguous(),
             torch.zeros((B, C, Dc), device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    out = {}
    for it in range(iters + 1):
        x_new, x_e, v = admm_kernel.admm_iter_pre_plain(state[1], state[2],
                                                        g, t, inv_mu)
        z_new = project_parity_polytope(v, mask=t.cmask)
        if it == 0:
            out["i"] = (t, state, x_new, x_e, z_new)
        if it == iters:
            out["ii"] = (t, state, x_new, x_e, z_new)
            break
        state = admm_kernel.admm_iter_post_plain(
            *state[:3], x_new, x_e, z_new, *state[3:], t, mu_t, thresh)[:5]
    return out, thresh


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="")
    ap.add_argument("--rows", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=36)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_admm_step.py needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    inputs, thresh_t = make_inputs(args.batch, args.iters, dev)
    thresh = float(thresh_t)
    t = inputs["i"][0]
    st = admm_step.step_tables(t)
    C, Dc = t.chk_var.shape
    V = t.var_slot.shape[0]

    with tempfile.TemporaryDirectory() as tmp:
        # name -> (wrapper module, extra keyword arguments)
        kernels, before, after = {}, [], []
        if args.parent:
            kernels["parent"] = (copy_of(parent_tree(args.parent, tmp), tmp,
                                         "parent_admm_step"), {})
            before, after = ["parent"], ["parent"]
        for i, tree in enumerate(v for v in args.variants.split(",") if v):
            name = os.path.basename(os.path.normpath(tree))
            kernels[name] = (copy_of(tree, tmp, f"variant_{i}"), {})
            before.append(name)
            after.insert(0, name)
        changes = []
        for rows in [r for r in args.rows.split(",") if r] or [""]:
            kw, name = {}, "change"
            if rows:
                kw = {"plan": admm_step.post_plan(C, Dc, int(rows))}
                name = f"change[{rows}]"
            kernels[name] = (admm_step, kw)
            changes.append(name)
        for name, (mod, kw) in kernels.items():
            plan = kw.get("plan") or (admm_step.post_plan(C, Dc)
                                      if mod is admm_step else None)
            print(f"kernel {name}: {plan if plan else 'its own launch'} "
                  f"| {card}", flush=True)

        flush = torch.empty(2 ** 26, dtype=torch.int32, device=dev)
        bad = []
        for label, (_, state, x_new, x_e, z_new) in inputs.items():
            running = int((~state[4]).sum())
            want = admm_kernel.admm_iter_post_plain(
                *state[:3], x_new, x_e, z_new, *state[3:], t,
                torch.tensor(MU, device=dev), thresh_t)
            word_bytes = 4 * (5 * C * Dc + 2 * V)
            nbytes = running * word_bytes + (args.batch if label == "ii"
                                             else 0)
            bound = 1e3 * nbytes / HBM_BYTES_PER_S
            print(f"input ({label}): B={args.batch}, {CODE}, biawgn {SNR} "
                  f"dB, running words {running} (frozen share "
                  f"{1 - running / args.batch:.4f}), words left after K3 "
                  f"{int(want[5])}; bound {bound:.4f} ms by bytes "
                  f"({nbytes} B) | {card}", flush=True)
            work = [a.clone() for a in state]

            def launch(name):
                mod, kw = kernels[name]
                return mod.admm_iter_post_cuda(
                    *work[:3], x_new, None, z_new, *work[3:], st, MU, thresh,
                    **kw)

            def restore():
                for a, b in zip(work, state):
                    a.copy_(b)
                flush.zero_()

            for name in kernels:
                try:
                    restore()
                    got = launch(name)
                    torch.cuda.synchronize()
                    diff = [k for k, a, b in zip(
                        ("x", "z", "lam", "updates", "done", "left"), got,
                        want) if not torch.equal(a, b)]
                except RuntimeError as e:
                    diff = [f"failed: {e}"]
                ok = not diff
                print(f"check ({label}) {name}: "
                      + ("bit-equal to admm_iter_post_plain" if ok else
                         f"differs in {diff}") + f" | {card}", flush=True)
                if not ok and (name in changes or name == "parent"):
                    bad.append((label, name))

            ms = {name: [] for name in kernels}
            for name in before + changes + changes + after:
                best = float("inf")
                for rep in range(args.reps + 1):
                    restore()
                    # The card spins while the host enqueues the launch, so
                    # the events time the launch alone.
                    torch.cuda._sleep(SPIN_CYCLES)
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                    try:
                        launch(name)
                    except RuntimeError:
                        break
                    stop.record()
                    torch.cuda.synchronize()
                    if rep:         # the first launch warms up
                        best = min(best, start.elapsed_time(stop))
                ms[name].append(best)
            for name, v in ms.items():
                print(f"timing ({label}) {name}: "
                      + " / ".join(f"{a:.4f}" for a in v)
                      + f" ms; bound {bound:.4f} ms | {card}", flush=True)
        if bad:
            sys.exit(f"not bit-equal to the plain version: {bad}")


if __name__ == "__main__":
    main()
