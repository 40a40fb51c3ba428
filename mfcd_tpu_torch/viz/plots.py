"""Visualization suite — host-side plotting over the results schema.

Counterpart of ``mfcd_tpu/viz/plots.py``, copied: the port keeps its own
copy because importing any ``mfcd_tpu`` module imports jax.  Host-only:
matplotlib is not needed to run a sweep, and nothing on the sweep path
imports this module.  Fresh implementation of the reference's plotting layer
(``visualization.py``, 21 public functions) against the same
``[{'params', 'results'}]`` schema produced by ``parameter_scan``.
LaTeX text rendering is opt-in via :func:`enable_latex` (the reference
enables it globally, ``visualization.py:14-19``; here it degrades
gracefully on TeX-less machines).

All functions consume plain numpy/python data — no JAX dependency — so the
module is importable anywhere the pickles are.
"""

from __future__ import annotations

import math
from collections import defaultdict
from itertools import product
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

import os

import matplotlib

if not os.environ.get("DISPLAY"):
    matplotlib.use("Agg")
import matplotlib.pyplot as plt
import matplotlib.ticker as mticker
from matplotlib.colors import LogNorm

try:
    from scipy.stats import sem as _sem
except Exception:  # pragma: no cover
    def _sem(a):
        a = np.asarray(a, dtype=float)
        return a.std(ddof=1) / math.sqrt(len(a)) if len(a) > 1 else 0.0


def enable_latex(enable: bool = True) -> None:
    """Turn on the reference's LaTeX rendering (``visualization.py:14-19``)."""
    matplotlib.rcParams.update(
        {
            "text.usetex": enable,
            "font.family": "serif" if enable else
            matplotlib.rcParamsDefault["font.family"],
            "text.latex.preamble": r"\usepackage{amsmath}" if enable else "",
        }
    )


# Display-name map including the strategy aliases the report figures use
# (reference ``visualization.py:54-96``).
_NAME_MAP = {
    "train_losses": "Training Loss",
    "val_losses": "Validation Loss",
    "accuracy": "Accuracy",
    "log_likelihoods": "Log Likelihood",
    "gt_accuracy": "GT Accuracy",
    "gt_log_likelihoods": "GT Log Likelihood",
    "reconstruction_errors": "Reconstruction Error",
    "reconstruction_error_scaled": "Reconstruction Error (Scaled)",
    "svd_error_scaled": "SVD Error (Scaled)",
    "gt_loss": "GT Loss",
    "pearson_corr": "Pearson Correlation",
    "spearman_corr": "Spearman Correlation",
    "lr": "Learning Rate",
    "weight_decay": "Weight Decay",
    "num_epochs": "Num Epochs",
    "num_data_points": "Num Data Points",
    "p": "$p$",
    "d": "Embedding Dim ($d$)",
    "d1": "Init Dim (d1)",
    "K": "$k$",
    "n": "$n$",
    "m": "$m$",
    "s": "$s$",
    "alpha": r"$\alpha(s)$",
    "pxK": r"$p \cdot k$",
    "norm_ratio": r"$\|UV^T\|/\|X^*\|$",
    "norm_ratio_scaled": r"$\|\alpha(s) UV^T\|/\|X^*\|$",
    "strategy": "Strat",
    "popularity": "Popularity",
    "cluster": "Cluster",
    "proximity": "Max-Min",
    "svd": "SVD",
    "top_k": r"Top 10\%",
    "p*s": r"p$\cdot$s",
    "margin": "Close-Call",
    "variance": r"high $\sigma$",
}


def format_display_name(name):
    """Internal name -> human/figure label (reference ``visualization.py:32``)."""
    if name in _NAME_MAP:
        label = _NAME_MAP[name]
        # The reference escapes % for its always-on usetex mode; without
        # LaTeX, mathtext renders the backslash literally.
        if not matplotlib.rcParams.get("text.usetex", False):
            label = label.replace(r"\%", "%")
        return label
    if isinstance(name, str):
        return name.replace("_", " ").title()
    return str(name)


def _is_loss_metric(metric: str) -> bool:
    return "loss" in metric.lower() or "error" in metric.lower()


def _metric_values(values) -> List[float]:
    """Normalize a results entry to a flat per-rep list; list-of-lists
    (loss curves) take the last-epoch value (reference
    ``visualization.py:1134-1135``)."""
    if isinstance(values, (float, int)):
        return [float(values)]
    if isinstance(values, list) and values and isinstance(values[0], list):
        return [float(v[-1]) for v in values]
    return [float(v) for v in np.asarray(values).ravel()]


def _mean_sem(values):
    vals = _metric_values(values)
    return float(np.mean(vals)), (float(_sem(vals)) if len(vals) > 1 else 0.0)


def enrich_params_with_data_points(results):
    """Add derived ``num_data_points = n*m*p*0.5``
    (reference ``visualization.py:344-370``)."""
    for exp in results:
        pr = exp["params"]
        pr["num_data_points"] = round(pr["n"] * pr["m"] * pr["p"] * 0.5, 4)
    return results


def display_experiment_indices(results):
    """Index table printer (reference ``visualization.py:752-774``)."""
    print("\nAvailable Experiments:")
    print("Index | Parameters")
    print("--------------------------------------")
    for idx, exp in enumerate(results):
        params_str = ", ".join(f"{k}={v}" for k, v in exp["params"].items())
        print(f"{idx:<5} | {params_str}")
    print(
        "\nUse these indices to select experiments in other functions like "
        "plot_losses or plot_heatmap_fixed."
    )


def get_best_params(results, result_metric):
    """Best configuration for one metric: min over reps for losses/errors,
    max otherwise (reference ``visualization.py:815-848``)."""
    is_loss = _is_loss_metric(result_metric)
    scores = [
        (min if is_loss else max)(_metric_values(exp["results"][result_metric]))
        for exp in results
    ]
    best_idx = int(np.argmin(scores) if is_loss else np.argmax(scores))
    best = results[best_idx]
    print(
        f"Best parameters for {result_metric} (Index: {best_idx}): "
        f"{best['params']}, Best value: {scores[best_idx]}"
    )
    return best["params"], best_idx


def get_best_params_all_metrics(results):
    """Best config per metric (reference ``visualization.py:851-871``).

    Deeply-nested diagnostic entries (``sampled_*_rows`` and the per-row
    matrices) have no scalar "best"; the reference silently ranks them by
    Python list comparison — here they are skipped by inspecting the value
    shape up front (a blanket except would also hide genuine bugs in the
    scalar path, ADVICE r2)."""
    def _is_rankable(value):
        # Probe only the value normalization of the FIRST experiment: the
        # diagnostic entries are ragged (per-row lists of varying length)
        # and fail to flatten.  Errors raised later inside get_best_params
        # (argmin over all experiments, printing) are genuine bugs and
        # propagate.
        try:
            return len(_metric_values(value)) > 0
        except (TypeError, ValueError):
            return False

    out = {}
    for metric in results[0]["results"].keys():
        if _is_rankable(results[0]["results"][metric]):
            out[metric] = get_best_params(results, metric)
    return out


def print_results(results, indices=None, params_off=False, metric=None):
    """Tabular results printer (reference ``visualization.py:874-897``)."""
    if indices is None:
        indices = range(len(results))
    if metric is None:
        metric = list(results[0]["results"].keys())[0]
    for idx in indices:
        exp = results[idx]
        params_str = "" if params_off else f"Params: {exp['params']}"
        print(f"Index {idx}: {params_str} | {metric}: {exp['results'][metric]}")


def smart_formatter(val):
    """Human-readable tick formatting (reference ``visualization.py:900-924``).

    Moderate values use the reference's comma-locale decimal rendering
    (thousands separated by spaces, decimal comma), e.g. 2.50 -> "2,5".
    """
    if val == 0:
        return "0"
    abs_val = abs(val)
    if 1e-2 <= abs_val < 1e3:
        return (
            f"{val:,.2f}".replace(",", " ").replace(".", ",")
            .rstrip("0").rstrip(",")
        )
    exponent = int(np.floor(np.log10(abs_val)))
    base = round(val / (10**exponent), 1)
    if base == 1.0:
        return f"$10^{{{exponent}}}$"
    return rf"${base}\times10^{{{exponent}}}$"


def format_ticks_smart(axis, axis_type="x"):
    """Apply smart formatting (reference ``visualization.py:926-940``)."""
    formatter = mticker.FuncFormatter(lambda val, _: smart_formatter(val))
    (axis.xaxis if axis_type == "x" else axis.yaxis).set_major_formatter(
        formatter
    )


def assign_gradient_colors(sorted_keys, cmap_name="viridis"):
    """Evenly spaced colormap colors (reference ``visualization.py:943-958``)."""
    cmap = plt.get_cmap(cmap_name)
    num = len(sorted_keys)
    return {k: cmap(i / max(1, num - 1)) for i, k in enumerate(sorted_keys)}


def find_varying_params(results):
    keys = results[0]["params"].keys()
    return [
        k
        for k in keys
        if len({repr(exp["params"].get(k)) for exp in results}) > 1
    ]


def _maybe_save(fig, save_path, suffix=""):
    if save_path:
        path = f"{save_path}{suffix}.png"
        fig.savefig(path, bbox_inches="tight", dpi=300)
        print(f"Saved figure as {path}")


def plot_losses(results, param_index=None, selected_indices=None, save_path="",
                show_plot=True):
    """Train/val loss curves, single- or multi-experiment
    (reference ``visualization.py:104-218``).  Shows the last repetition."""
    if param_index is not None:
        exp = results[param_index]
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.plot(exp["results"]["train_losses"][-1], "--", label="Training Loss")
        ax.plot(exp["results"]["val_losses"][-1], label="Validation Loss")
        ax.set_xlabel("Epochs")
        ax.set_ylabel("Loss")
        params_str = ", ".join(
            f"{format_display_name(k)}: {v}" for k, v in exp["params"].items()
        )
        ax.set_title(f"Train & Val Loss for {params_str}"[:120], fontsize=10)
        ax.grid(True, linestyle="--", alpha=0.6)
        ax.legend()
        _maybe_save(fig, save_path)
        if show_plot:
            plt.show()
        plt.close(fig)
        return

    varying = find_varying_params(results)
    if selected_indices is None:
        selected_indices = range(len(results))
    colors = plt.cm.viridis(np.linspace(0, 1, max(len(selected_indices), 1)))

    for which, suffix in (("train_losses", "_train"), ("val_losses", "_val")):
        fig, ax = plt.subplots(figsize=(10, 5))
        for ci, exp_idx in enumerate(selected_indices):
            exp = results[exp_idx]
            label = ", ".join(
                f"{format_display_name(k)}={exp['params'][k]}" for k in varying
            )
            ax.plot(exp["results"][which][-1], color=colors[ci],
                    label=f"Exp {exp_idx + 1}: {label}")
        ax.set_xlabel("Epochs")
        ax.set_ylabel(format_display_name(which))
        ax.grid(True, linestyle="--", alpha=0.6)
        if len(list(selected_indices)) <= 12:
            ax.legend(fontsize=7, ncol=2)
        _maybe_save(fig, save_path, suffix)
        if show_plot:
            plt.show()
        plt.close(fig)


def _format_sci(v):
    if abs(v) >= 1000 or (abs(v) < 0.01 and v != 0):
        return (
            f"{v:.1e}".replace("e+00", "").replace("e+0", "e")
            .replace("e-0", "e-")
        )
    return f"{v:.2f}".rstrip("0").rstrip(".")


def _heatmap(ax, data, invert_colors, log_scale, param_x, param_y,
             invert_x, invert_y, font_scale, vmin=None, vmax=None):
    """Shared heatmap renderer over ``{(x, y): (mean, sem)}``."""
    x_values = sorted({k[0] for k in data})
    y_values = sorted({k[1] for k in data})
    if invert_x:
        x_values = x_values[::-1]
    if invert_y:
        y_values = y_values[::-1]
    mat = np.zeros((len(y_values), len(x_values)))
    for (x, y), (mean_val, _err) in data.items():
        mat[y_values.index(y), x_values.index(x)] = mean_val

    means = [v[0] for v in data.values()]
    if vmin is None:
        vmin = np.percentile(means, 5)
    if vmax is None:
        vmax = np.percentile(means, 95)
    norm = None
    if log_scale:
        vmin = max(vmin, 1e-5)
        vmax = max(vmax, vmin * 10)
        norm = LogNorm(vmin=vmin, vmax=vmax)

    cmap = "coolwarm_r" if invert_colors else "coolwarm"
    im = ax.imshow(
        mat, cmap=cmap, norm=norm, aspect="auto",
        vmin=None if norm else vmin, vmax=None if norm else vmax,
    )
    for (x, y), (mean_val, err_val) in data.items():
        txt = f"{mean_val:.3f}"
        if err_val > 0:
            txt += f"\n±{err_val:.3f}"
        ax.text(
            x_values.index(x), y_values.index(y), txt,
            ha="center", va="center", fontsize=8 * font_scale,
        )
    ax.set_xticks(range(len(x_values)))
    ax.set_xticklabels([_format_sci(v) for v in x_values], rotation=45,
                       ha="right", fontsize=10 * font_scale)
    ax.set_yticks(range(len(y_values)))
    ax.set_yticklabels([_format_sci(v) for v in y_values],
                       fontsize=10 * font_scale)
    ax.set_xlabel(format_display_name(param_x), fontsize=12 * font_scale)
    ax.set_ylabel(format_display_name(param_y), fontsize=12 * font_scale)
    plt.colorbar(im, ax=ax)
    return im


def plot_heatmap_best_fixed(results, param_x, param_y, result_metric,
                            save_path="", invert_colors=False, log_scale=False,
                            ignored_keys=None, overall=True, invert_x=False,
                            invert_y=False, fig_size=(10, 7), font_scale=1,
                            show_plot=True):
    """Best-per-cell / best-global-block 2-param heatmap
    (reference ``visualization.py:220-342``)."""
    ignored_keys = ignored_keys or []
    is_loss = _is_loss_metric(result_metric)
    data = {}

    exps = results
    if not overall:
        # Filter to the global best configuration's block.
        best_params, _ = get_best_params(results, result_metric)
        exps = [
            e for e in results
            if all(
                e["params"].get(k) == best_params[k]
                for k in best_params
                if k not in [param_x, param_y] + ignored_keys
            )
        ]

    for exp in exps:
        if param_x not in exp["params"] or param_y not in exp["params"]:
            continue
        x, y = exp["params"][param_x], exp["params"][param_y]
        mean_val, err_val = _mean_sem(exp["results"][result_metric])
        key = (x, y)
        if (
            key not in data
            or (is_loss and mean_val < data[key][0])
            or (not is_loss and mean_val > data[key][0])
        ):
            data[key] = (mean_val, err_val)

    fig, ax = plt.subplots(figsize=fig_size)
    _heatmap(ax, data, invert_colors, log_scale, param_x, param_y,
             invert_x, invert_y, font_scale)
    ax.set_title(
        f"Heatmap of {format_display_name(result_metric)} by "
        f"{format_display_name(param_x)} and {format_display_name(param_y)}",
        fontsize=13 * font_scale,
    )
    _maybe_save(fig, save_path)
    if show_plot:
        plt.show()
    plt.close(fig)


def plot_heatmap_fixed(results, param_x, param_y, result_metric, fixed_index,
                       save_path="", invert_colors=False, log_scale=False,
                       ignored_keys=None, overall=True, invert_x=False,
                       invert_y=False, ax=None, font_scale=1, show_plot=True):
    """Heatmap with all other params fixed to ``results[fixed_index]``
    (reference ``visualization.py:375-487``)."""
    ignored_keys = ignored_keys or []
    fixed_params = results[fixed_index]["params"]
    data = {}
    for exp in results:
        if all(
            exp["params"].get(k) == fixed_params[k]
            for k in fixed_params
            if k not in [param_x, param_y] + ignored_keys
        ):
            x, y = exp["params"][param_x], exp["params"][param_y]
            mean_val, err_val = _mean_sem(exp["results"][result_metric])
            if (x, y) in data:
                pm, pe = data[(x, y)]
                data[(x, y)] = ((pm + mean_val) / 2, (pe + err_val) / 2)
            else:
                data[(x, y)] = (mean_val, err_val)

    standalone = ax is None
    if standalone:
        fig, ax = plt.subplots(figsize=(10, 7))
    _heatmap(ax, data, invert_colors, log_scale, param_x, param_y,
             invert_x, invert_y, font_scale)
    if standalone:
        _maybe_save(ax.figure, save_path)
        if show_plot:
            plt.show()
        plt.close(ax.figure)


def find_fixed_indices(results, param_x, param_y, ignored_keys=None):
    """First index of each distinct fixed configuration
    (reference ``visualization.py:490-529``)."""
    ignored_keys = ignored_keys or []
    seen, indices = set(), []
    for idx, exp in enumerate(results):
        fixed = tuple(
            (k, repr(v))
            for k, v in exp["params"].items()
            if k not in [param_x, param_y] + ignored_keys
        )
        if fixed not in seen:
            seen.add(fixed)
            indices.append(idx)
    return indices


def plot_multiple_heatmaps(results, param_x, param_y, result_metric,
                           fixed_indices=None, fig_size=(12, 10), save_path="",
                           invert_colors=False, log_scale=False,
                           ignored_keys=None, invert_x=False, invert_y=False,
                           sub_plot=True, font_scale=1, show_plot=True):
    """Grid of heatmaps, shared color scale
    (reference ``visualization.py:588-748``)."""
    ignored_keys = ignored_keys or []
    if fixed_indices is None:
        fixed_indices = find_fixed_indices(results, param_x, param_y,
                                           ignored_keys)
    if len(fixed_indices) == 1:
        plot_heatmap_fixed(results, param_x, param_y, result_metric,
                           fixed_indices[0], save_path=save_path,
                           log_scale=log_scale, invert_colors=invert_colors,
                           ignored_keys=ignored_keys, invert_x=invert_x,
                           invert_y=invert_y, font_scale=font_scale,
                           show_plot=show_plot)
        return

    num_rows = len(fixed_indices) // 2 + (len(fixed_indices) % 2)
    fig, axes = plt.subplots(num_rows, 2, figsize=fig_size,
                             constrained_layout=True)
    axes = np.atleast_1d(axes).flatten()
    for i, fixed_index in enumerate(fixed_indices):
        plot_heatmap_fixed(results, param_x, param_y, result_metric,
                           fixed_index, ax=axes[i], log_scale=log_scale,
                           invert_colors=invert_colors,
                           ignored_keys=ignored_keys, invert_x=invert_x,
                           invert_y=invert_y, font_scale=font_scale)
    for j in range(len(fixed_indices), len(axes)):
        fig.delaxes(axes[j])
    _maybe_save(fig, save_path)
    if show_plot:
        plt.show()
    plt.close(fig)


def plot_all_heatmaps(results, param_x, param_y, result_metric,
                      fig_size=(12, 10), save_path="", invert_colors=False,
                      log_scale=False, ignored_keys=None, max_=False,
                      overall=True, invert_x=False, invert_y=False,
                      sub_plot=True, font_scale=1, show_plot=True):
    """One heatmap per fixed configuration, or the best-config heatmap when
    ``max_`` (reference ``visualization.py:532-583``)."""
    if max_:
        print("Maximizing the result metric")
        plot_heatmap_best_fixed(
            results, param_x, param_y, result_metric, save_path=save_path,
            invert_colors=invert_colors, log_scale=log_scale,
            ignored_keys=ignored_keys, overall=overall, invert_x=invert_x,
            invert_y=invert_y, fig_size=fig_size, font_scale=font_scale,
            show_plot=show_plot,
        )
        return
    indices = find_fixed_indices(results, param_x, param_y, ignored_keys)
    plot_multiple_heatmaps(results, param_x, param_y, result_metric, indices,
                           fig_size, save_path, invert_colors, log_scale,
                           ignored_keys=ignored_keys, invert_x=invert_x,
                           invert_y=invert_y, sub_plot=sub_plot,
                           font_scale=font_scale, show_plot=show_plot)


def plot_3d_scatter(results, param_x, param_y, param_z, result_metric,
                    use_plotly=True, save_path=None, show_plot=True):
    """Interactive 3D scatter via plotly when available
    (reference ``visualization.py:777-812``); matplotlib fallback (used
    when plotly is absent, fails, or ``use_plotly=False``)."""
    rows = [
        {
            param_x: exp["params"][param_x],
            param_y: exp["params"][param_y],
            param_z: exp["params"][param_z],
            result_metric: max(_metric_values(exp["results"][result_metric])),
        }
        for exp in results
    ]
    if use_plotly:
        try:
            import pandas as pd
            import plotly.express as px

            df = pd.DataFrame(rows)
            fig = px.scatter_3d(
                df, x=param_x, y=param_y, z=param_z, color=result_metric,
                opacity=0.8,
                title=f"3D Scatter of {format_display_name(result_metric)}",
            )
            if save_path:
                fig.write_html(f"{save_path}.html")
            if show_plot:
                fig.show()
            return
        except Exception:
            pass
    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(
        [r[param_x] for r in rows],
        [r[param_y] for r in rows],
        [r[param_z] for r in rows],
        c=[r[result_metric] for r in rows],
    )
    plt.colorbar(sc, ax=ax, label=format_display_name(result_metric))
    ax.set_xlabel(param_x)
    ax.set_ylabel(param_y)
    ax.set_zlabel(param_z)
    if save_path:
        fig.savefig(f"{save_path}.png", bbox_inches="tight", dpi=200)
    if show_plot:
        plt.show()
    plt.close(fig)


def plot_metrics_vs_param(results, param_x, metrics, group_by=None,
                          split_by=None, title="", grid=True, save_path=None,
                          ylim=None, log_scale_x=False, log_scale_y=False,
                          sub_plot=True, max_overall=False, show_plot=True,
                          use_color_gradient=True, font_scale=1.0,
                          GT_plot=True, stds=None, dashed=False,
                          fill_between=False, line=False, close=True):
    """The workhorse: metric(s) vs a parameter, ``group_by`` curves,
    ``split_by`` panels, SEM errorbars, best-over-hidden-params mode, GT
    overlay (reference ``visualization.py:960-1086``)."""
    group_by = [group_by] if isinstance(group_by, str) else (group_by or [])
    split_by = [split_by] if isinstance(split_by, str) else (split_by or [])
    metrics = [metrics] if isinstance(metrics, str) else metrics

    markers = ["o", "s", "D", "^", "v", "x"]
    linestyles = ["-", "--", "-.", ":"]
    metric_styles = {
        m: {"marker": markers[i % 6], "linestyle": linestyles[i % 4]}
        for i, m in enumerate(metrics)
    }

    unique_values = {
        k: sorted({exp["params"].get(k) for exp in results}, key=str)
        for k in split_by
    }
    combos = list(product(*(unique_values[k] for k in split_by))) or [()]
    split_groups = {}
    for combo in combos:
        combo_dict = dict(zip(split_by, combo))
        matching = [
            e for e in results
            if all(e["params"].get(k) == v for k, v in combo_dict.items())
        ]
        if matching:
            split_groups[tuple((k, combo_dict[k]) for k in split_by)] = matching

    if sub_plot:
        num = len(split_groups)
        ncols = min(2, max(num, 1))
        nrows = math.ceil(max(num, 1) / ncols)
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(7 * ncols, 5.5 * nrows),
                                 squeeze=False)
        for idx, (split_key, grp) in enumerate(split_groups.items()):
            ax = axes[idx // ncols][idx % ncols]
            _plot_one_panel(ax, grp, param_x, metrics, group_by, metric_styles,
                            split_key, title, grid, ylim, log_scale_x,
                            log_scale_y, max_overall, use_color_gradient,
                            font_scale, GT_plot, stds, dashed, fill_between,
                            line)
            format_ticks_smart(ax, "x")
            format_ticks_smart(ax, "y")
        for j in range(num, nrows * ncols):
            fig.delaxes(axes[j // ncols][j % ncols])
        plt.tight_layout()
        if save_path:
            _maybe_save(fig, save_path)
        if show_plot:
            plt.show()
        if close:
            plt.close(fig)
    else:
        for split_key, grp in split_groups.items():
            fig, ax = plt.subplots(figsize=(9, 6))
            _plot_one_panel(ax, grp, param_x, metrics, group_by, metric_styles,
                            split_key, title, grid, ylim, log_scale_x,
                            log_scale_y, max_overall, use_color_gradient,
                            font_scale, GT_plot, stds, dashed, fill_between,
                            line)
            format_ticks_smart(ax, "x")
            format_ticks_smart(ax, "y")
            plt.tight_layout()
            if save_path:
                suffix = "_".join(f"{k}_{v}" for k, v in split_key)
                _maybe_save(fig, save_path, f"_{suffix}" if suffix else "")
            if show_plot:
                plt.show()
            plt.close(fig)


def _plot_one_panel(ax, group_results, param_x, metrics, group_by,
                    metric_styles, split_key, title, grid, ylim, log_scale_x,
                    log_scale_y, max_overall, use_color_gradient, font_scale,
                    GT_plot, stds, dashed, fill_between, line):
    """Single-panel internals (reference ``visualization.py:1088-1256``)."""
    grouped = defaultdict(list)
    for exp in group_results:
        gk = tuple((k, exp["params"].get(k)) for k in group_by)
        grouped[gk].append(exp)
    sorted_keys = sorted(grouped.keys(), key=lambda ks: [str(v) for _, v in ks])
    color_map = (
        assign_gradient_colors(sorted_keys)
        if use_color_gradient
        else {g: plt.cm.tab10(i % 10 / 10) for i, g in enumerate(sorted_keys)}
    )

    grouped_by_x_latest = {}
    x_vals = []
    for group_key in sorted_keys:
        grouped_by_x = defaultdict(list)
        for exp in grouped[group_key]:
            grouped_by_x[exp["params"][param_x]].append(exp)
        grouped_by_x_latest = grouped_by_x
        x_vals = sorted(grouped_by_x.keys())

        for metric in metrics:
            means, errs = [], []
            is_loss = _is_loss_metric(metric)
            for x in x_vals:
                cand = []
                for exp in grouped_by_x[x]:
                    mean_val, err_val = _mean_sem(exp["results"][metric])
                    if stds is not None:
                        err_val = float(np.mean(exp["results"][stds]))
                    cand.append((mean_val, err_val))
                if max_overall:
                    best = min(cand) if is_loss else max(cand)
                    means.append(best[0])
                    errs.append(best[1])
                else:
                    means.append(float(np.mean([c[0] for c in cand])))
                    errs.append(float(np.mean([c[1] for c in cand])))

            style = metric_styles[metric]
            label_parts = [
                f"{format_display_name(k)}="
                f"{format_display_name(v) if k == 'strategy' else v}"
                for k, v in group_key
            ]
            label = (
                f"{format_display_name(metric)} ({', '.join(label_parts)})"
                if group_by and len(metrics) > 1
                else ", ".join(label_parts)
                if group_by
                else format_display_name(metric)
            )
            fmt = "--" if dashed else style["marker"] + style["linestyle"]
            yerrs = np.asarray(errs)
            color = color_map[group_key]
            if np.any(yerrs > 0) and not line:
                if fill_between:
                    ax.plot(x_vals, means, fmt, label=label, color=color)
                    ax.fill_between(
                        x_vals, np.asarray(means) - yerrs,
                        np.asarray(means) + yerrs, color=color, alpha=0.2,
                    )
                else:
                    ax.errorbar(x_vals, means, yerr=yerrs, fmt=fmt, capsize=5,
                                label=label, color=color)
            else:
                ax.plot(x_vals, means, fmt, label=label, color=color)

    split_label = ", ".join(
        f"{format_display_name(k)}={v}" for k, v in split_key
    )
    ax.set_title(f"{title} {split_label}".strip(), fontsize=14 * font_scale)
    ax.set_xlabel(format_display_name(param_x), fontsize=12 * font_scale)
    ax.set_ylabel(
        ", ".join(format_display_name(m) for m in metrics),
        fontsize=12 * font_scale,
    )
    if grid:
        ax.grid(True, linestyle="--", alpha=0.6)
    if ylim:
        ax.set_ylim(ylim)
    if log_scale_x:
        ax.set_xscale("log")
    if log_scale_y:
        ax.set_yscale("log")

    # GT accuracy overlay, dashed gray, at the largest K
    # (reference ``visualization.py:1240-1253``).
    if metrics == ["accuracy"] and GT_plot:
        k_vals = [e["params"].get("K") for e in group_results
                  if "K" in e["params"]]
        if k_vals:
            max_k = max(k_vals)
            gt_x, gt_y = [], []
            for x in x_vals:
                matching = [
                    e for e in grouped_by_x_latest.get(x, [])
                    if e["params"].get("K") == max_k
                    and "gt_accuracy" in e["results"]
                ]
                if matching:
                    gt_x.append(x)
                    gt_y.append(np.mean([
                        np.mean(_metric_values(e["results"]["gt_accuracy"]))
                        for e in matching
                    ]))
            if gt_x:
                ax.plot(gt_x, gt_y, linestyle="--", color="gray", label="GT")

    ax.legend(fontsize=9 * font_scale)


def plot_optimal_param_vs_x(results, param_x, parameter, metric,
                            group_by=None, log_scale_x=False,
                            log_scale_y=False, save_path=None, font_scale=1.5,
                            title=None, show_plot=True):
    """Argmax/argmin of a tuned parameter vs x
    (reference ``visualization.py:1258-1354``)."""
    maximize = not _is_loss_metric(metric)
    group_by = [group_by] if isinstance(group_by, str) else (group_by or [])

    grouped = defaultdict(list)
    for exp in results:
        key = tuple((g, exp["params"][g]) for g in group_by)
        grouped[(key, exp["params"][param_x])].append(exp)

    curves = defaultdict(list)
    for (group_key, x_val), exps in grouped.items():
        cand = [
            (np.mean(_metric_values(e["results"][metric])),
             e["params"][parameter])
            for e in exps
        ]
        best = max(cand) if maximize else min(cand)
        matching = [v for s, v in cand if s == best[0]]
        err = float(_sem(matching)) if len(matching) > 1 else 0.0
        curves[group_key].append((x_val, best[1], err))

    fig, ax = plt.subplots(figsize=(9, 6))
    for group_key, data in curves.items():
        data = sorted(data)
        label = (
            ", ".join(f"{format_display_name(k)}={v}" for k, v in group_key)
            if group_by else None
        )
        ax.errorbar(
            [d[0] for d in data], [d[1] for d in data],
            yerr=[d[2] for d in data], label=label, capsize=4, marker="o",
        )
    ax.set_xlabel(format_display_name(param_x), fontsize=12 * font_scale)
    ax.set_ylabel(f"Optimal {format_display_name(parameter)}",
                  fontsize=12 * font_scale)
    ax.set_title(
        title
        or f"Optimal {format_display_name(parameter)} vs "
           f"{format_display_name(param_x)}",
        fontsize=14 * font_scale,
    )
    if log_scale_x:
        ax.set_xscale("log")
    if log_scale_y:
        ax.set_yscale("log")
    if group_by:
        ax.legend(fontsize=11 * font_scale)
    ax.grid(True, linestyle="--", alpha=0.6)
    plt.tight_layout()
    if save_path:
        _maybe_save(fig, save_path)
    if show_plot:
        plt.show()
    plt.close(fig)


def plot_histograms_from_results(results, metric, group_by=None, split_by=None,
                                 font_scale=1.0, error_type=None, title=None,
                                 save_path=None, bins_num=None, log_x=False,
                                 log_y=False, show_plot=True):
    """Histograms / error-bar bars of per-row metrics
    (reference ``visualization.py:1362-1451``)."""
    bins_num = bins_num or "auto"
    group_by = [group_by] if isinstance(group_by, str) else (group_by or [])
    split_by = [split_by] if isinstance(split_by, str) else (split_by or [])

    split_dict = defaultdict(list)
    for exp in results:
        key = (
            tuple((k, exp["params"][k]) for k in split_by)
            if split_by else (("All", "All"),)
        )
        split_dict[key].append(exp)

    num = len(split_dict)
    ncols = min(2, num)
    nrows = -(-num // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(6 * ncols, 5 * nrows),
                             squeeze=False)
    axes = axes.flatten()

    for idx, (split_key, exps) in enumerate(split_dict.items()):
        ax = axes[idx]
        data = defaultdict(list)
        for exp in exps:
            values = exp["results"][metric]
            if isinstance(values, list) and values and isinstance(
                values[0], list
            ):
                values = [v for sub in values for v in sub]
            elif not isinstance(values, list):
                values = [values]
            key = tuple(exp["params"].get(g, "All") for g in group_by) or (
                "All",)
            data[key].extend(values)

        if error_type in ("std", "sem"):
            keys = sorted(data.keys(), key=str)
            means = [np.mean(data[k]) for k in keys]
            errors = [
                np.std(data[k]) if error_type == "std" else _sem(data[k])
                for k in keys
            ]
            xs = np.arange(len(keys))
            ax.bar(xs, means, yerr=errors, capsize=5, alpha=0.7)
            ax.set_xticks(xs)
            ax.set_xticklabels(
                [", ".join(map(str, k)) for k in keys],
                rotation=30, ha="right", fontsize=9 * font_scale,
            )
        else:
            for k, vals in data.items():
                ax.hist(vals, bins=bins_num, alpha=0.6,
                        label=", ".join(map(str, k)))
            ax.legend(fontsize=9 * font_scale)
        if title:
            ax.set_title(title, fontsize=14 * font_scale)
        if log_x:
            ax.set_xscale("log")
        if log_y:
            ax.set_yscale("log")
        ax.set_xlabel(format_display_name(metric), fontsize=11 * font_scale)
        ax.grid(True, linestyle="--", alpha=0.5)

    for j in range(num, len(axes)):
        fig.delaxes(axes[j])
    plt.tight_layout()
    if save_path:
        _maybe_save(fig, save_path)
    if show_plot:
        plt.show()
    plt.close(fig)
