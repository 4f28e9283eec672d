"""Training/eval plotting utilities (vestigial reference surface).

Own copy of the JAX package's train/plots.py; matplotlib is imported
inside the functions, so importing the module needs none.

Rebuilds the behaviour of the reference's matplotlib helpers -- save_plot
(reference lib/utils/funcs_utils.py:211-231) and plot_joint_error
(reference lib/utils/vis_utils.py:247-276) -- on a shared line-plot
core, with the output directory as an explicit argument instead of the
global cfg.graph_dir. Behavioural contract preserved: file names derived
from the lowercased title, 'b-'/'r-' line styles, unit/50-frame x-tick
grids, the min-loss annotation arrow, and plot_joint_error's one-zero
padding of the angle-error series. Neither is on the scoring path (the
training code is vestigial in the reference, SURVEY.md section 2.13)."""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence, Tuple

import numpy as np


def _title_to_filename(title: str, ext: str) -> str:
    return "_".join(title.split(" ")).lower() + ext


def _series_plot(series: Sequence[Tuple[np.ndarray, str, str]], plot_title: str,
                 xlabel: str, xtick_step: float, out_path: str,
                 annotate_min: Optional[float] = None) -> str:
    """Shared core: 1-indexed line series, legend, [0, n+1] x-range, small
    tick labels, optional min-value annotation arrow. The axis range is
    sized from the FIRST series only -- the reference sizes the MPJVE&MPJAE
    plot's xlim/xticks from len(mpjve) alone (vis_utils.py:270-272) even
    though the padded MPJAE series is one entry longer."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(series[0][0])
    fig = plt.figure()
    for values, style, label in series:
        plt.plot(np.arange(1, len(values) + 1), values, style, label=label)
    plt.legend()
    plt.title(plot_title)
    plt.xlabel(xlabel)
    plt.xlim(left=0, right=n + 1)
    plt.xticks(np.arange(0, n + 1, xtick_step), fontsize=5)
    if annotate_min is not None:
        plt.annotate(
            "%0.2f" % annotate_min, xy=(1, annotate_min), xytext=(8, 0),
            arrowprops=dict(arrowstyle="simple", connectionstyle="angle3"),
            xycoords=("axes fraction", "data"), textcoords="offset points",
        )
    os.makedirs(osp.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def save_plot(data_list: Sequence[float], epoch: int, graph_dir: str,
              title: str = "Train Loss") -> str:
    """Loss-curve pdf ('train_loss.pdf' for the default title): the PLOT
    title carries the epoch suffix but the FILE name comes from the bare
    title -- the reference's asymmetry, kept."""
    values = np.asarray(data_list, np.float64)
    return _series_plot(
        [(values, "b-", "{} epoch {}".format(title, epoch))],
        "{} epoch {}".format(title, epoch),
        "epoch", 1.0,
        osp.join(graph_dir, _title_to_filename(title, ".pdf")),
        annotate_min=float(values.min()),
    )


def plot_joint_error(mpjpe: np.ndarray, mpjve: np.ndarray, mpjae: np.ndarray,
                     graph_dir: str) -> Tuple[str, str]:
    """Per-frame error jpgs: 'mpjpe.jpg' (position error) and
    'mpjve_&_mpjae.jpg' (velocity + angle error; the angle series is
    zero-padded by one entry to line up with the velocity series, exactly
    like the reference's concatenate)."""
    mpjae = np.concatenate((np.asarray(mpjae, np.float64), np.zeros((1,))))
    path1 = _series_plot(
        [(np.asarray(mpjpe, np.float64), "b-", "MPJPE")],
        "MPJPE", "frame", 50.0,
        osp.join(graph_dir, _title_to_filename("MPJPE", ".jpg")),
    )
    path2 = _series_plot(
        [
            (np.asarray(mpjve, np.float64), "b-", "MPJVE"),
            (mpjae, "r-", "MPJAE"),
        ],
        "MPJVE & MPJAE", "frame", 50.0,
        osp.join(graph_dir, _title_to_filename("MPJVE & MPJAE", ".jpg")),
    )
    return path1, path2
