"""Matplotlib helpers of the plots (counterpart of
``ldpc_decoders_tpu.utils.mpl``). matplotlib is imported inside the
functions that need it, so importing this module needs none."""

from __future__ import annotations


def init(font_size: int = 12, legend_font_size: int = 12,
         tick_size: int = 12) -> None:
    import matplotlib
    matplotlib.rcParams.update({
        "font.size": font_size,
        "legend.fontsize": legend_font_size,
        "xtick.labelsize": tick_size,
        "ytick.labelsize": tick_size,
    })


def fmt_ax(ax, xlab: str, ylab: str, leg: int = 0, grid: int = 0,
           grid_kwargs=None) -> None:
    ax.set_xlabel(xlab)
    ax.set_ylabel(ylab)
    if leg:
        ax.legend(loc="best")
    if grid:
        ax.grid(True, **(grid_kwargs or {}))


def bind_fig_save_args(parser):
    parser.add_argument("--save", action="store_true",
                        help="save the figure instead of showing it")
    parser.add_argument("--ext", default="png", help="figure file extension")
    parser.add_argument("--dpi", type=int, default=120)
    return parser


def save_show_fig(args, plt, img_path_noext: str) -> None:
    if getattr(args, "save", False) or getattr(args, "agg", False):
        path = f"{img_path_noext}.{getattr(args, 'ext', 'png')}"
        plt.savefig(path, dpi=getattr(args, "dpi", 120), bbox_inches="tight")
        print("saved:", path)
    else:
        plt.show()
