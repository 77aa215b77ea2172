"""Registry-dispatched result plotting (counterpart of
``ldpc_decoders_tpu.viz.graph``).

Plot types ``plot_all``, ``ensemble``, ``regex_average``, ``hist_iter``
and ``avg_iter``; file-name token filters (--and/--or_), auto-generated
distinguishing legends, log-y BER/WER axes, legend formats, batch save.
Reads the Saver JSON schema (per-metric dicts keyed by str(param)), the
same files either package writes. ``run(args)`` returns the data list
(``DataRoot`` per plotted file, sorted by label). matplotlib is imported
when a ``Plotter`` is made, so importing this module needs none;
``--agg`` draws without a display.

Usage:
    python -m ldpc_decoders_tpu_torch.viz.graph --data_dir artifacts/data \\
        --and bsc-7_4_hamming --error wer --legend_format decoder \\
        --plots_dir plots --file_name hmg_bsc --agg
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np

from ldpc_decoders_tpu_torch.utils import mpl as ut_mpl
from ldpc_decoders_tpu_torch.utils.file import (
    bind_filter_args,
    filter_strings,
    gen_unique_labels,
    get_data_file_list,
    load_json,
    make_dir_if_not_exists,
    naturalkey,
)
from ldpc_decoders_tpu_torch.utils.registry import Registry

X_LABELS = {"bsc": "Crossover probability",
            "bec": "Erasure probability",
            "biawgn": "E_b/N in dB for E_b=1"}

legend_reg = Registry()
legend_reg.put("decoder", lambda d: d["decoder"])
legend_reg.put("channel_decoder",
               lambda d: d["channel"].upper() + ", %s decoder" % d["decoder"])
legend_reg.put("channel_code",
               lambda d: d["channel"].upper() + ", %s code" % d["code"])

plot_reg = Registry()


def reg_plot(help_str):
    def inner(func):
        func.help_str = help_str
        plot_reg.put(func.__name__, func)
        return func
    return inner


class DataRoot:
    """One result file and its display label."""

    def __init__(self, file_name, label, args):
        self.file_name = file_name
        self.label = label
        self.args = args
        self.data = load_json(os.path.join(args.data_dir, file_name))
        if self.data is None:
            print(">>>>>>>> failed to load:", file_name)

    def get_label(self):
        if self.args.legend_format is None:
            return self.label
        return legend_reg.get(self.args.legend_format)(self.data)


class Plotter:
    """Holds the plotting context (the reference used module globals)."""

    def __init__(self, args):
        self.args = args
        import matplotlib
        if args.agg:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        self.plt = plt
        ut_mpl.init()
        # A fresh figure per Plotter: batch cases render many figures in
        # one process and must not accumulate axes state.
        plt.figure()

    # -- primitives -----------------------------------------------------
    def plot_pairs(self, pairs, label, style=None):
        """{str(param): value} -> sorted line plot."""
        pts = sorted(((float(k), v) for k, v in pairs.items()))
        xs, ys = zip(*pts)
        kwargs = {"linewidth": self.args.linewidth, "label": label}
        if style is None:
            self.plt.plot(xs, ys, **kwargs)
        else:
            self.plt.plot(xs, ys, style, **kwargs)

    def comp_average(self, dl):
        """Pointwise average over files."""
        pot = {}
        for r in dl:
            for point, val in r.data[self.args.error].items():
                pot.setdefault(point, []).append(val)
        return {p: sum(v) / float(len(v)) for p, v in pot.items()}

    def fmt_err(self):
        xlab = X_LABELS[self.args.channel]
        ut_mpl.fmt_ax(self.plt.gca(), xlab, self.args.error.upper(),
                      leg=1, grid=1, grid_kwargs={"which": "both"})
        self.plt.yscale("log")

    def finish(self, title=None):
        args = self.args
        self.plt.legend(loc="best")
        if args.xlim is not None:
            self.plt.xlim(args.xlim)
        if args.ylim is not None:
            self.plt.ylim(args.ylim)
        if args.title is not None:
            title = args.title
        if title:
            self.plt.title(title)
        self.plt.margins(0)
        make_dir_if_not_exists(args.plots_dir)
        ut_mpl.save_show_fig(
            args, self.plt, os.path.join(args.plots_dir, args.file_name))
        if getattr(args, "agg", False) or getattr(args, "save", False):
            self.plt.close()


# ----------------------------------------------------------------------
# Plot types
# ----------------------------------------------------------------------

@reg_plot("plots of all available data")
def plot_all(p: Plotter, dl):
    for r in dl:
        p.plot_pairs(r.data[p.args.error], r.get_label())
    p.fmt_err()
    p.finish()


@reg_plot("ensemble of codes and their average")
def ensemble(p: Plotter, dl):
    for r in dl:
        p.plot_pairs(r.data[p.args.error], None, "r--")
    p.plot_pairs(p.comp_average(dl), "Average", "b-")
    p.fmt_err()
    p.finish("Performance of code ensemble")


@reg_plot("compute average of regex matching files")
def regex_average(p: Plotter, dl):
    used = []
    for rg, name in (p.args.group_regex or []):
        group = [r for r in dl if re.search(rg, r.file_name)]
        used.extend(group)
        print("Regex group: %s" % rg, *[r.file_name for r in group],
              sep="\n")
        p.plot_pairs(p.comp_average(group), name)
    for r in [r for r in dl if r not in used]:
        p.plot_pairs(r.data[p.args.error], r.get_label())
    p.fmt_err()
    p.finish()


@reg_plot("histogram of iteration count for e.g. ADMM decoder")
def hist_iter(p: Plotter, dl):
    ax = p.plt.gca()
    if p.args.param is None:
        raise ValueError("--param required for hist_iter")
    xmin, xmax = 1e10, 0
    for r in dl:
        stats = r.data["dec"][str(p.args.param)]
        series = np.array(stats["iter"])
        ax.bar(range(len(series)), series,
               label="Average=%g" % stats["average"])
        nz = series.nonzero()[0]
        if nz.size:
            xmin, xmax = min(xmin, nz[0]), max(xmax, nz[-1])
    ax.set_yticks([])
    diff = max(3, int((xmax - xmin) * 0.01))
    ax.set_xlim(max(0, xmin - diff), xmax + diff)
    ut_mpl.fmt_ax(ax, "Number of iterations", "Frequency", leg=1, grid=1)
    p.finish("Iteration count histogram")


@reg_plot("average iteration count for e.g. ADMM decoder")
def avg_iter(p: Plotter, dl):
    for r in dl:
        dec = r.data["dec"]
        p.plot_pairs({pt: dec[pt]["average"] for pt in dec}, r.get_label())
    ut_mpl.fmt_ax(p.plt.gca(), X_LABELS[p.args.channel],
                  "Average number of iterations", leg=1, grid=1)
    p.finish("Average iteration count")


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def run(args) -> list:
    file_names = filter_strings(args, get_data_file_list(args.data_dir))
    if not file_names:
        print("no matching result files in", args.data_dir)
        return []
    labels = gen_unique_labels(file_names)
    p = Plotter(args)
    dl = [DataRoot(fn, lb, args) for fn, lb in zip(file_names, labels)]
    dl = [r for r in dl if r.data is not None]
    if not dl:
        print("no loadable result files in", args.data_dir)
        return []
    dl.sort(key=lambda r: naturalkey(r.get_label()))
    args.channel = dl[0].data["channel"]
    plot_reg.get(args.type)(p, dl)
    return dl


def setup_parser():
    parser = argparse.ArgumentParser(description="plot simulation results")
    parser.add_argument("--type", choices=plot_reg.keys(), default="plot_all")
    parser.add_argument("--param", type=float,
                        help="parameter for hist_iter")
    parser.add_argument("--error", default="ber", choices=["wer", "ber"])
    parser.add_argument("--group_regex", nargs=2, action="append",
                        help="regex_average groups: <regex> <legend>")
    parser.add_argument("--linewidth", type=float, default=2)
    parser.add_argument("--xlim", nargs=2, type=float)
    parser.add_argument("--ylim", nargs=2, type=float)
    parser.add_argument("--legend_format", choices=legend_reg.keys())
    parser.add_argument("--title", type=str)
    parser.add_argument("--file_name", type=str, default="graph")
    parser.add_argument("--agg", action="store_true",
                        help="use the Agg backend (save, don't show)")
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--plots_dir", default="plots")
    ut_mpl.bind_fig_save_args(parser)
    bind_filter_args(parser)
    return parser


def main(argv=None):
    args = setup_parser().parse_args(argv)
    print(vars(args))
    run(args)


if __name__ == "__main__":
    main()
