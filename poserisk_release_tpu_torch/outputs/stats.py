"""Score post-processing: stats + plot, byte-parity with the reference.

Mirrors Predictor.post_processing (reference lib/core/base.py:242-271):
sort scores DESCENDING, then avg / top-50% / top-10% / max rounded to 3dp and
scipy mode (smallest modal value on ties); the unsorted copy feeds the CSV
and video paths. The matplotlib plot reproduces title/labels/xlim.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Sequence, Tuple

import numpy as np


def post_process_scores(
    results: List[dict],
    timestamp: Tuple[int, np.ndarray, int],
    output_path: str,
    title: str,
    make_plot: bool = True,
):
    """results: scorer output dicts. Returns (final_scores_5tuple,
    scores_in_frame_order, log_scores)."""
    scores = np.array([r["score"] for r in results])
    logs = np.array([r["log_score"] for r in results], dtype=object)

    if make_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.title(title + " Score")
        plt.xlim([timestamp[0], timestamp[2]])
        plt.xlabel("frames")
        plt.ylabel("score")
        plt.plot(timestamp[1], scores)
        plt.savefig(osp.join(output_path, title + "_score.png"))
        plt.clf()

    scores_log = np.copy(scores)
    return final_scores_stats(scores), scores_log, logs


def final_scores_stats(scores) -> Tuple[float, float, float, float, int]:
    """(avg, top50, top10, max, mode) with the reference's exact semantics
    (base.py:263-271): sort DESCENDING, head-slice means for the top 50%/10%
    (clips shorter than 2/10 frames give NaN there, like the reference's
    empty-slice numpy means), 3dp rounding, scipy mode (smallest modal value
    on ties). The ONE implementation shared by post_process_scores and
    streaming.StreamResult.stats so the stat semantics cannot fork. Raises
    ValueError on an empty list -- the reference dies less legibly there
    (mean of an empty array)."""
    scores = np.sort(np.asarray(scores))[::-1]
    if scores.size == 0:
        raise ValueError(
            "no scored frames: score statistics need at least one score")
    score_avg = round(float(scores.mean()), 3)
    score50 = round(float(scores[: len(scores) // 2].mean()), 3)
    score10 = round(float(scores[: len(scores) // 10].mean()), 3)
    # Dtype-preserving like the reference (base.py:269): REBA/RULA frame
    # scores are integers, so the literal `round(scores.max(), 3)` is an
    # int and the txt prints "MAX Score: 12", not "12.0" -- a float() cast
    # here changed that surface (caught by the executed-oracle e2e diff,
    # tests/test_reference_differential_predictor.py).
    score_max = round(scores.max(), 3)
    from scipy.stats import mode  # 2-3 s to import: only where the stats are made

    score_mode = mode(scores).mode.item()
    return (score_avg, score50, score10, score_max, score_mode)


def format_result_txt(final_scores: Sequence, action_level, action_name, trailing_space: bool) -> str:
    """The reference result-file body (base.py:162-163 / 179-180), including
    the line-continuation whitespace its f-string embeds (21 spaces before
    MAX) and REBA's trailing space after the action name."""
    tail = " " if trailing_space else ""
    return (
        f"AVG Score: {final_scores[0]} \n%50 Score: {final_scores[1]} \n%10 Score: {final_scores[2]} "
        f"                    \nMAX Score: {final_scores[3]} \nMODE Score: {final_scores[4]} "
        f"\nAction level: {action_level} \nAction: {action_name}{tail}"
    )


def write_result_txt(output_path: str, title: str, final_scores: Sequence,
                     action_level, action_name) -> None:
    """Write the reference-format {title,lower}_result.txt (base.py:160-182).

    The single writer for BOTH the batch Predictor and the streaming
    scorer, so the parity format (incl. REBA's trailing space) cannot fork
    between entry points."""
    body = format_result_txt(
        final_scores, action_level, action_name,
        trailing_space=(title == "REBA"),
    )
    with open(osp.join(output_path, title.lower() + "_result.txt"), "w") as f:
        f.write(body)


def print_result_summary(summary: dict) -> None:
    """The reference's stdout summary block (base.py:189-209), shared by the
    batch and streaming CLI paths. `summary` maps title -> (final_scores,
    action_level, action_name)."""
    for title, (final_scores, action_level, action_name) in summary.items():
        print(f"\n----- {title} -----")
        print("AVG Score:\t", final_scores[0])
        print("%50 Score:\t", final_scores[1])
        print("%10 Score:\t", final_scores[2])
        print("MAX Score:\t", final_scores[3])
        print("MODE Score:\t", final_scores[4])
        print("\nAction Level:\t", action_level)
        print("Action:\t\t", action_name)
        print()


def finite_or_none(value):
    """NaN/inf -> None so the machine-readable JSON summaries stay strictly
    parseable (the parity txt/stdout surfaces keep the reference's NaN for
    <10-frame clips -- stats.py top-10% mean of an empty slice)."""
    if isinstance(value, np.generic):
        value = value.item()  # np.int64 max would not json.dump
    try:
        v = float(value)
    except (TypeError, ValueError):
        return value
    return value if np.isfinite(v) else None


def scores_summary_block(summary: dict) -> dict:
    """The per-title scores block of run_summary.json / stream_summary.json.

    ONE helper for both writers (pipeline.py and streaming.write_outputs) so
    the machine-readable schema cannot fork between the batch and streaming
    entry points. `summary` maps title -> (final_scores, action_level,
    action_name) -- the same structure print_result_summary consumes."""
    return {
        title: {
            "avg": finite_or_none(s[0][0]), "p50": finite_or_none(s[0][1]),
            "p10": finite_or_none(s[0][2]), "max": finite_or_none(s[0][3]),
            "mode": finite_or_none(s[0][4]),
            "action_level": s[1], "action": s[2],
        }
        for title, s in summary.items()
    }
