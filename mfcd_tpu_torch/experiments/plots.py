"""Scripted equivalents of the ``Plots.ipynb`` report-figure cells.

Counterpart of ``experiments/plots.py``, copied, drawing through the
port's ``viz``.  Each function consumes pickles produced by
``mfcd_tpu_torch.experiments.runs`` or ``experiments.runs`` (or the
reference's own pickles — the schema is identical) and regenerates the
corresponding report figures.  Figures land in ``--outdir``.  Host-only:
it needs matplotlib, which a sweep does not.

Usage:
    python -m mfcd_tpu_torch.experiments.plots s_sweep_figures --pickle Data_final/s_p.pkl
    python -m mfcd_tpu_torch.experiments.plots --list
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

from mfcd_tpu_torch.viz.plots import (
    enrich_params_with_data_points,
    plot_all_heatmaps,
    plot_losses,
    plot_metrics_vs_param,
    plot_optimal_param_vs_x,
)
from mfcd_tpu_torch.viz.report import (
    find_closest_index_by_s,
    plot_alpha_vs_s,
    plot_sampled_comparison_aligned,
)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def s_sweep_figures(pickle_path, outdir="Results_final", show=False):
    """Plots.ipynb cells 3-8: accuracy / reconstruction / correlations /
    alpha vs s, grouped by K or p (whichever varies), split by weight
    decay."""
    results = _load(pickle_path)
    os.makedirs(outdir, exist_ok=True)
    group = "K" if len({e["params"]["K"] for e in results}) > 1 else "p"
    tag = f"_by_{group}" if group != "p" else ""
    kw = dict(log_scale_x=True, sub_plot=True, font_scale=1.5,
              show_plot=show)
    plot_metrics_vs_param(
        results, "s", ["accuracy"], group_by=group,
        save_path=f"{outdir}/accuracy_vs_s{tag}", max_overall=True, **kw)
    plot_metrics_vs_param(
        results, "s", ["reconstruction_error_scaled"], group_by=group,
        save_path=f"{outdir}/reconstruction_scaled_vs_s{tag}",
        max_overall=True, **kw)
    plot_metrics_vs_param(
        results, "s", ["pearson_corr"], group_by=group,
        save_path=f"{outdir}/pearson_vs_s{tag}", max_overall=True,
        fill_between=True, **kw)
    plot_metrics_vs_param(
        results, "s", ["spearman_corr"], group_by=group,
        save_path=f"{outdir}/spearman_vs_s{tag}", max_overall=True,
        fill_between=True, **kw)
    wds = sorted({e["params"]["weight_decay"] for e in results})
    plot_alpha_vs_s(results, s_min=0.0, weight_decays=wds,
                    save_path=f"{outdir}/alpha_vs_s{tag}", show_plot=show)


def per_row_diagnostics(pickle_path, outdir="Results_final", show=False,
                        s_targets=(0.1, 5, 100)):
    """Plots.ipynb cells 11-15: sampled-row alignment plots + the per-row
    alpha histogram."""
    results = _load(pickle_path)
    os.makedirs(outdir, exist_ok=True)
    for s_t in s_targets:
        idx = find_closest_index_by_s(results, s_t)
        if idx < 0:
            continue
        uvt_rows = results[idx]["results"]["sampled_UVT_rows"][0]
        x_rows = results[idx]["results"]["sampled_X_rows"][0]
        plot_sampled_comparison_aligned(
            uvt_rows[0], x_rows[0], title=f"s = {s_t}",
            save_path=f"{outdir}/sample_comparison_s_{s_t}.png",
            show_plot=show,
        )
    from mfcd_tpu_torch.viz.plots import plot_histograms_from_results

    plot_histograms_from_results(
        results[: min(4, len(results))], "alpha_per_row", group_by="s",
        save_path=f"{outdir}/alpha_per_row_hist", show_plot=show,
    )


def p_sweep_figures(pickle_path, outdir="Results_final", show=False,
                    derived=(), tag=""):
    """Plots.ipynb cells 17-23: accuracy/error vs p (and derived pxK / p*s
    axes when present), with the GT overlay.

    ``derived`` names product axes to patch into the params in-memory
    before plotting ("pxK", "p*s"), as the reference's plot cells do
    post-hoc for the constant-product pickles.  ``tag`` suffixes the
    vs-p figure names so several pickles can share an outdir."""
    results = _load(pickle_path)
    os.makedirs(outdir, exist_ok=True)
    enrich_params_with_data_points(results)
    for key in derived:
        assert key in ("pxK", "p*s"), key
        other = "K" if key == "pxK" else "s"
        for exp in results:
            exp["params"][key] = round(
                exp["params"]["p"] * exp["params"][other], 4)
    sfx = f"_{tag}" if tag else ""
    kw = dict(log_scale_x=True, sub_plot=True, font_scale=1.5,
              show_plot=show)
    plot_metrics_vs_param(
        results, "p", ["accuracy"], group_by="K",
        save_path=f"{outdir}/accuracy_vs_p{sfx}", **kw)
    plot_metrics_vs_param(
        results, "num_data_points", ["reconstruction_error_scaled"],
        group_by="K", save_path=f"{outdir}/rec_vs_datapoints{sfx}",
        max_overall=True, **kw)
    for key in ("pxK", "p*s"):
        if key in results[0]["params"]:
            plot_metrics_vs_param(
                results, key, ["accuracy"], group_by="s",
                save_path=f"{outdir}/accuracy_vs_{key.replace('*', 'x')}",
                **kw)


def strategy_figures(pickle_glob, outdir="Results_final", show=False):
    """Plots.ipynb cells 26-28: strategy comparison (per-strategy pickles
    merged with a 'strategy' group key)."""
    import glob

    merged = []
    for path in sorted(glob.glob(pickle_glob)):
        merged.extend(_load(path))
    os.makedirs(outdir, exist_ok=True)
    x_key = "s" if len({e["params"]["s"] for e in merged}) > 1 else "p"
    # Name figures by the swept axis so the vs-s (cell 26) and vs-p
    # (cell 28) variants coexist; keep the legacy names for the s-sweep.
    tag = "" if x_key == "s" else f"_vs_{x_key}"
    plot_metrics_vs_param(
        merged, x_key, ["accuracy"], group_by="strategy",
        log_scale_x=True, sub_plot=True, font_scale=1.5,
        max_overall=True, save_path=f"{outdir}/strategies_accuracy{tag}",
        show_plot=show,
    )
    plot_metrics_vs_param(
        merged, x_key, ["reconstruction_error_scaled"], group_by="strategy",
        log_scale_x=True, sub_plot=True, font_scale=1.5,
        max_overall=True, save_path=f"{outdir}/strategies_rec{tag}",
        show_plot=show,
    )


def generation_figures(pickle_glob, outdir="Results_final", show=False):
    """Generation-mode comparison (non-base X* generators swept over s):
    accuracy and scaled reconstruction vs s, one curve per mode."""
    import glob

    merged = []
    for path in sorted(glob.glob(pickle_glob)):
        merged.extend(_load(path))
    os.makedirs(outdir, exist_ok=True)
    kw = dict(log_scale_x=True, sub_plot=True, font_scale=1.5,
              max_overall=True, show_plot=show)
    plot_metrics_vs_param(
        merged, "s", ["accuracy"], group_by="generation",
        save_path=f"{outdir}/generation_accuracy_vs_s", **kw)
    plot_metrics_vs_param(
        merged, "s", ["reconstruction_error_scaled"], group_by="generation",
        save_path=f"{outdir}/generation_rec_vs_s", **kw)


def gt_figures(pickle_path, outdir="Results_final", show=False):
    """Plots.ipynb cells 31-33: GT-oracle accuracy curves + SEM plot."""
    results = _load(pickle_path)
    os.makedirs(outdir, exist_ok=True)
    import matplotlib.pyplot as plt

    from mfcd_tpu_torch.viz.report import aggregate_by_param

    x_key = "p" if len({e["params"]["p"] for e in results}) > 1 else "d"
    plot_metrics_vs_param(
        results, x_key, ["gt_accuracy"], group_by="K" if x_key == "p" else "s",
        log_scale_x=x_key == "p", sub_plot=True, font_scale=1.5,
        save_path=f"{outdir}/gt_accuracy_vs_{x_key}", show_plot=show,
    )
    vals, _means, sems = aggregate_by_param(results, x_key)
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(vals, sems, "d-", label="SEM of GT Accuracy")
    ax.set_xlabel(f"${x_key}$")
    ax.set_ylabel("Error on Accuracy")
    if x_key == "p":
        ax.set_xscale("log")
    ax.grid(True, linestyle="--", alpha=0.5)
    fig.tight_layout()
    fig.savefig(f"{outdir}/gt_error_vs_{x_key}.png", dpi=300)
    if show:
        plt.show()
    plt.close(fig)


def loss_curves(pickle_path, outdir="Results_final", show=False):
    """Loss-curve panels for the first experiments of a pickle."""
    results = _load(pickle_path)
    os.makedirs(outdir, exist_ok=True)
    plot_losses(results, param_index=0, save_path=f"{outdir}/losses_exp0",
                show_plot=show)
    plot_losses(results, selected_indices=list(range(min(8, len(results)))),
                save_path=f"{outdir}/losses_all", show_plot=show)


def heatmaps(pickle_path, outdir="Results_final", show=False,
             param_x="s", param_y="p", metric="accuracy"):
    """Heatmap grids (Plots.ipynb heatmap cells).

    ``param_x`` / ``param_y`` must both vary in the pickle (so the p x d
    grid is called with ``--param-x p --param-y d``, not the s x p
    defaults); the optimal-weight-decay panel only renders when more than
    one weight decay was swept."""
    results = _load(pickle_path)
    os.makedirs(outdir, exist_ok=True)
    for axis in (param_x, param_y):
        values = {e["params"][axis] for e in results}
        if len(values) < 2:
            raise ValueError(
                f"heatmap axis {axis!r} has a single value {values} in "
                f"{pickle_path}; pass --param-x/--param-y for the swept "
                "parameters")
    plot_all_heatmaps(
        results, param_x, param_y, metric,
        save_path=f"{outdir}/heatmap_{metric}_{param_x}_{param_y}",
        max_=True, show_plot=show,
    )
    if len({e["params"]["weight_decay"] for e in results}) > 1:
        plot_optimal_param_vs_x(
            results, param_x, "weight_decay", metric,
            save_path=f"{outdir}/optimal_wd_vs_{param_x}", show_plot=show,
        )


ALL = {
    fn.__name__: fn
    for fn in (
        s_sweep_figures, per_row_diagnostics, p_sweep_figures,
        strategy_figures, generation_figures, gt_figures, loss_curves,
        heatmaps,
    )
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("figures", nargs="?", choices=sorted(ALL))
    ap.add_argument("--pickle", default=None,
                    help="results pickle (or glob for strategy_figures)")
    ap.add_argument("--outdir", default="Results_final")
    ap.add_argument("--derived", action="append", default=[],
                    choices=["pxK", "p*s"],
                    help="product axis to patch into the params "
                         "(p_sweep_figures only)")
    ap.add_argument("--tag", default="",
                    help="figure-name suffix (p_sweep_figures only)")
    ap.add_argument("--param-x", default="s",
                    help="heatmap x axis (heatmaps only)")
    ap.add_argument("--param-y", default="p",
                    help="heatmap y axis (heatmaps only)")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)
    if args.list or not args.figures:
        for name, fn in sorted(ALL.items()):
            print(f"{name:22s} {fn.__doc__.splitlines()[0]}")
        return 0
    extra = {}
    if args.figures == "p_sweep_figures":
        extra = dict(derived=tuple(args.derived), tag=args.tag)
    elif args.figures == "heatmaps":
        extra = dict(param_x=args.param_x, param_y=args.param_y)
    ALL[args.figures](args.pickle, outdir=args.outdir, **extra)
    return 0


if __name__ == "__main__":
    sys.exit(main())
