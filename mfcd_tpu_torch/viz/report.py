"""Report-figure helpers — the Plots.ipynb notebook-local utilities.

Counterpart of ``mfcd_tpu/viz/report.py``, copied (numpy, matplotlib and
scipy only).  Fresh implementations of the helpers the reference defines
inline in its plotting notebook (``Plots.ipynb`` cells 4/8/11/15/31):
row-alignment inspection plots, the alpha-vs-s figure with its 1/s
overlay, per-parameter SEM aggregation, color shading, and the
Pearson/Spearman outlier sensitivity demo.  All consume the standard results schema.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence

import numpy as np
import matplotlib.pyplot as plt
from matplotlib import colors as mcolors

try:
    from scipy.stats import sem as _sem, spearmanr
except Exception:  # pragma: no cover
    _sem = None
    spearmanr = None

from mfcd_tpu_torch.viz.plots import plot_metrics_vs_param


def shift_color(color, factor: float = 0.85):
    """Darken/lighten a color (Plots.ipynb cell 4)."""
    r, g, b, a = mcolors.to_rgba(color)
    return (min(r * factor, 1), min(g * factor, 1), min(b * factor, 1), a)


def find_closest_index_by_s(results, s_target: float) -> int:
    """Index of the experiment whose ``s`` is closest to ``s_target``
    (Plots.ipynb cell 11)."""
    best, best_idx = float("inf"), -1
    for i, res in enumerate(results):
        s_val = res["params"].get("s")
        if s_val is not None and abs(s_val - s_target) < best:
            best = abs(s_val - s_target)
            best_idx = i
    return best_idx


def plot_sampled_comparison_aligned(
    UVT_row, X_row, title=None, save_path=None, font_scale: float = 1.5,
    real_index=None, show_plot: bool = True,
):
    """Dual-axis plot of one UVᵀ row vs the matching X row, sorted by X
    (Plots.ipynb cell 11) — the visual-inspection companion of the
    ``sampled_UVT_rows`` / ``sampled_X_rows`` result keys."""
    UVT_row = np.asarray(UVT_row)
    X_row = np.asarray(X_row)
    sort_idx = np.argsort(X_row)
    x = np.arange(len(X_row))

    fig, ax1 = plt.subplots(figsize=(8, 5))
    ax1.set_ylabel(r"$UV^\top$", color="tab:red", fontsize=12 * font_scale)
    ax1.plot(x, UVT_row[sort_idx], color="tab:red", label=r"$UV^\top$")
    ax1.tick_params(axis="y", labelcolor="tab:red")
    ax2 = ax1.twinx()
    ax2.set_ylabel(r"$X$", color="tab:blue", fontsize=12 * font_scale)
    ax2.plot(x, X_row[sort_idx], color="tab:blue", linestyle="--", label="$X$")
    ax2.tick_params(axis="y", labelcolor="tab:blue")
    fig.suptitle(title or r"$UV^\top$ vs $X$ (sorted)",
                 fontsize=14 * font_scale)
    ax1.set_xlabel("Sorted Index", fontsize=12 * font_scale)
    ax1.grid(True, linestyle="--", alpha=0.5)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=300)
    if show_plot:
        plt.show()
    plt.close(fig)


def plot_alpha_vs_s(
    results, s_min: float = -1, s_max: float = 1e5,
    weight_decays: Sequence[float] = (1e-5, 5e-5, 1e-4, 5e-4),
    save_path: Optional[str] = None, show_plot: bool = True,
    font_scale: float = 2.0,
):
    """alpha vs s (grouped by K, split by wd) with the 1/s reference overlay
    (Plots.ipynb cells 4/8) — the empirical check that the aligned scale
    approaches 1/s."""
    filtered = [
        exp for exp in results
        if s_min < exp["params"].get("s") < s_max
        and exp["params"].get("weight_decay") in weight_decays
    ]
    plot_metrics_vs_param(
        filtered, "s", ["alpha"], group_by="K", split_by="weight_decay",
        log_scale_x=True, log_scale_y=True, sub_plot=True,
        font_scale=font_scale, show_plot=False, close=False,
    )
    fig = plt.gcf()
    for ax in fig.get_axes():
        lines = ax.get_lines()
        if not lines:
            continue
        x_vals = np.asarray(lines[0].get_xdata(), dtype=float)
        x_vals = x_vals[x_vals > 0]
        if x_vals.size:
            ax.plot(x_vals, 1.0 / x_vals, "k--", label=r"$1/s$")
            ax.legend(fontsize=6 * font_scale)
    if save_path:
        fig.savefig(f"{save_path}.png", bbox_inches="tight", dpi=300)
    if show_plot:
        plt.show()
    plt.close(fig)


def aggregate_by_param(results, param_key: str):
    """Mean + SEM of gt_accuracy per value of ``param_key``
    (Plots.ipynb cell 31)."""
    param_values = sorted({res["params"][param_key] for res in results})
    means, errors = [], []
    for val in param_values:
        accs = [
            float(np.mean(res["results"]["gt_accuracy"]))
            for res in results
            if res["params"][param_key] == val
        ]
        means.append(float(np.mean(accs)))
        errors.append(float(_sem(accs)) if len(accs) > 1 else 0.0)
    return param_values, means, errors


def plot_outlier_impact(
    n_points: int = 200, n_outliers: int = 5, outlier_scale: float = 10.0,
    seed: int = 0, font_scale: float = 1.5, save_path: Optional[str] = None,
    show_plot: bool = True,
):
    """Synthetic Pearson-vs-Spearman outlier-sensitivity demo
    (Plots.ipynb cell 15): a clean linear relation plus a few large
    outliers collapses Pearson while Spearman stays near 1."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n_points)
    y = x + 0.1 * rng.normal(size=n_points)
    y_out = y.copy()
    idx = rng.choice(n_points, n_outliers, replace=False)
    y_out[idx] += outlier_scale * rng.normal(size=n_outliers)

    def metrics(a, b):
        pearson = float(np.corrcoef(a, b)[0, 1])
        rho = float(spearmanr(a, b)[0]) if spearmanr else float("nan")
        return pearson, rho

    p_clean, s_clean = metrics(x, y)
    p_out, s_out = metrics(x, y_out)

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, data, (p_v, s_v), name in (
        (axes[0], y, (p_clean, s_clean), "clean"),
        (axes[1], y_out, (p_out, s_out), f"{n_outliers} outliers"),
    ):
        ax.scatter(x, data, s=10, alpha=0.7)
        ax.set_title(
            f"{name}: Pearson={p_v:.3f}, Spearman={s_v:.3f}",
            fontsize=11 * font_scale,
        )
        ax.grid(True, linestyle="--", alpha=0.5)
    fig.tight_layout()
    if save_path:
        fig.savefig(f"{save_path}.png", bbox_inches="tight", dpi=300)
    if show_plot:
        plt.show()
    plt.close(fig)
    return {"pearson_clean": p_clean, "spearman_clean": s_clean,
            "pearson_outliers": p_out, "spearman_outliers": s_out}
