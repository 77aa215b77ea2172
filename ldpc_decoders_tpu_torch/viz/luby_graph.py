"""LT-code plots (counterpart of ``ldpc_decoders_tpu.viz.luby_graph``):
symbol-count histograms from luby result files (``luby_<c>.png``),
soliton-distribution bars, the average-degree curve.

matplotlib is imported inside the plotting functions only, so importing
this module needs none.

Usage:
    python -m ldpc_decoders_tpu_torch.viz.luby_graph hist 0.01 0.1 \
        --data_dir artifacts/data --plots_dir plots --agg
    python -m ldpc_decoders_tpu_torch.viz.luby_graph soliton 1000 0.03 0.5
    python -m ldpc_decoders_tpu_torch.viz.luby_graph avg_deg 500 0.5
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ldpc_decoders_tpu_torch.fountain.lt import robust_soliton, robust_soliton_parts
from ldpc_decoders_tpu_torch.utils.file import get_data_file_list, load_json


def _plt(agg: bool):
    import matplotlib
    if agg:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _avg_deg(dst: np.ndarray) -> float:
    return dst @ np.arange(1, len(dst) + 1)


def _show(plt, out):
    if out:
        plt.savefig(out, dpi=120)
    else:
        plt.show()


def plot_hist(arr, k, n, c, agg=False, out=None):
    plt = _plt(agg)
    plt.figure()
    plt.hist(arr, bins=50)
    plt.autoscale(enable=True, axis="x", tight=True)
    plt.title("c=%g, mean=%g, std_dev=%g, var=%g"
              % (c, np.mean(arr), np.std(arr), np.var(arr)))
    plt.xlim(k, n)
    _show(plt, out)
    if out:
        print("saved:", out)


def plot_soliton(rho, tau, mu, c, cut, agg=False, out=None):
    plt = _plt(agg)
    plt.figure()
    width = 0.32
    for i, (dst, name, clr) in enumerate(
            [(rho, "rho", "r"), (tau, "tau", "b"), (mu, "mu", "y")]):
        plt.bar(np.arange(1, cut + 1) + width * i, dst[:cut], width,
                linewidth=0, color=clr,
                label="%s, avg_deg=%g" % (name, _avg_deg(dst)))
    plt.autoscale(enable=True, axis="x", tight=True)
    plt.title("c=%g" % c)
    plt.legend()
    _show(plt, out)


def plot_avg_deg(ll_c, avg_deg, agg=False, out=None):
    """Average generator degree as a function of the soliton c parameter."""
    plt = _plt(agg)
    plt.figure()
    plt.plot(ll_c, avg_deg)
    _show(plt, out)


def soliton_case(k, c, delta, cut=103, agg=False, out=None):
    """The rho/tau/mu decomposition bars for one (k, c, delta)."""
    plot_soliton(*robust_soliton_parts(k, c, delta), c, cut, agg=agg, out=out)


def avg_deg_case(k, delta, agg=False, out=None):
    ll = np.linspace(.01, .1, 50)
    plot_avg_deg(ll, [_avg_deg(robust_soliton(k, c, delta)) for c in ll],
                 agg=agg, out=out)


def plot_files(data_dir, cs, agg=False, plots_dir=None):
    """One histogram per luby result file in ``data_dir`` whose c is in
    ``cs``, saved as ``<plots_dir>/luby_<c>.png`` (shown without
    ``plots_dir``). Returns the output paths."""
    outs = []
    for file_name in get_data_file_list(data_dir):
        data = load_json(os.path.join(data_dir, file_name))
        if not data or data.get("type") != "luby":
            continue
        if float(data["c"]) in cs:
            out = (os.path.join(plots_dir, f"luby_{data['c']}.png")
                   if plots_dir else None)
            plot_hist(data["arr"], int(data["k"]), int(data["n"]),
                      float(data["c"]), agg=agg, out=out)
            outs.append(out)
    return outs


def main(argv=None):
    p = argparse.ArgumentParser(description="LT plots")
    sub = p.add_subparsers(dest="mode", required=True)

    ph = sub.add_parser("hist", help="symbol-count histograms")
    ph.add_argument("c", nargs="+", type=float)
    ph.add_argument("--data_dir", default="data")
    ph.add_argument("--plots_dir", default=None)
    ph.add_argument("--agg", action="store_true")

    ps = sub.add_parser("soliton", help="rho/tau/mu decomposition bars")
    ps.add_argument("k", type=int)
    ps.add_argument("c", type=float)
    ps.add_argument("delta", type=float)
    ps.add_argument("--cut", type=int, default=103)
    ps.add_argument("--agg", action="store_true")
    ps.add_argument("--out", default=None)

    pa = sub.add_parser("avg_deg", help="average degree vs c")
    pa.add_argument("k", type=int)
    pa.add_argument("delta", type=float)
    pa.add_argument("--agg", action="store_true")
    pa.add_argument("--out", default=None)

    args = p.parse_args(argv)
    if args.mode == "hist":
        plot_files(args.data_dir, args.c, args.agg, args.plots_dir)
    elif args.mode == "soliton":
        soliton_case(args.k, args.c, args.delta, args.cut,
                     agg=args.agg, out=args.out)
    else:
        avg_deg_case(args.k, args.delta, agg=args.agg, out=args.out)


if __name__ == "__main__":
    main()
