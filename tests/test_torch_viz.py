"""The port's figures (``mfcd_tpu_torch.viz``, ``.experiments.plots``)
against the JAX package's: every public function of ``viz/plots.py``,
``viz/report.py`` and ``experiments/plots.py`` is called through both
packages on the same inputs, under Agg, and what each draws is compared.

``Figure.savefig`` is intercepted (nothing is written): at each save the
figure's axes are read back — line xy data, collection offsets and path
vertices, bars, image arrays, texts, titles, axis labels, tick labels and
legend texts — with the file name.  The inputs are synthetic results
shaped like ``tests/test_viz.py``'s and ``tests/test_plots_cells.py``'s,
and one pickle written by the port's CPU scan.  Both packages run the same
numpy code, so the data drawn must be equal, not close.
"""

import contextlib
import copy
import io
import os
import pickle

import matplotlib

matplotlib.use("Agg")

import matplotlib.figure  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import experiments.plots as jexp  # noqa: E402
from mfcd_tpu.viz import plots as jplots  # noqa: E402
from mfcd_tpu.viz import report as jreport  # noqa: E402
import mfcd_tpu_torch  # noqa: E402
from mfcd_tpu_torch.experiments import plots as texp  # noqa: E402
from mfcd_tpu_torch.viz import plots as tplots  # noqa: E402
from mfcd_tpu_torch.viz import report as treport  # noqa: E402

torch.set_num_threads(1)

JAX = dict(plots=jplots, report=jreport, exp=jexp)
PORT = dict(plots=tplots, report=treport, exp=texp)

# --- inputs -------------------------------------------------------------


def _viz_results():
    """``tests/test_viz.py``'s synthetic sweep (p x s x wd, 3 reps)."""
    rng = np.random.default_rng(0)
    results = []
    for p in (0.1, 0.2):
        for s in (1.0, 5.0):
            for wd in (1e-5, 1e-3):
                reps = 3
                results.append({
                    "params": {
                        "n": 100, "m": 100, "d": 2, "p": p, "s": s,
                        "lr": 1e-3, "weight_decay": wd, "num_epochs": 4,
                        "reps": reps, "K": 1, "d1": None,
                        "strategy": "random", "popularity_method": "zipf",
                        "alpha": 1.5, "soft_label": False,
                        "generation": "base",
                    },
                    "results": {
                        "accuracy": list(rng.uniform(0.5, 0.9, reps)),
                        "gt_accuracy": list(rng.uniform(0.7, 0.95, reps)),
                        "reconstruction_errors": list(
                            rng.uniform(0.2, 1.0, reps)),
                        "train_losses": [list(np.linspace(0.7, 0.3, 4))] * reps,
                        "val_losses": [list(np.linspace(0.72, 0.4, 4))] * reps,
                        "pearson_corr": list(rng.uniform(0, 1, reps)),
                        "slopes": [list(rng.normal(size=5))] * reps,
                        "alpha": [1.0 / s] * reps,
                    },
                })
    return results


REPS, EPOCHS, N, M = 2, 3, 12, 10


def _cell_results(rng):
    """``tests/test_plots_cells.py``'s 23-key results of one config."""
    n_kept = N - 1
    u = lambda lo, hi: list(rng.uniform(lo, hi, REPS))
    rows = lambda lo, hi: [list(rng.uniform(lo, hi, n_kept))
                           for _ in range(REPS)]
    return {
        "reconstruction_errors": u(0.2, 1.0),
        "log_likelihoods": list(-rng.uniform(0.4, 0.8, REPS)),
        "accuracy": u(0.5, 1.0),
        "gt_log_likelihoods": list(-rng.uniform(0.1, 0.3, REPS)),
        "gt_accuracy": u(0.6, 0.9),
        "train_losses": [list(rng.uniform(0.3, 0.7, EPOCHS))
                         for _ in range(REPS)],
        "val_losses": [list(rng.uniform(0.3, 0.7, EPOCHS))
                       for _ in range(REPS)],
        "alpha": u(0.1, 1.0),
        "norm_X": u(50, 60),
        "norm_ratio": u(0.5, 2.0),
        "reconstruction_error_scaled": u(0.1, 1.0),
        "pearson_corr": u(0.0, 1.0),
        "pearson_std": u(0.0, 0.2),
        "spearman_corr": u(0.0, 1.0),
        "spearman_std": u(0.0, 0.2),
        "svd_error_scaled": u(0.0, 1.0),
        "slopes": rows(0.0, 1.5),
        "pearson_corr_matrix": rows(0, 1),
        "spearman_corr_matrix": rows(0, 1),
        "reconstruction_error_scaled_per_row": u(0.1, 1.0),
        "alpha_per_row": rows(0.0, 1.5),
        "sampled_UVT_rows": [rng.normal(size=(2, M)).tolist()
                             for _ in range(REPS)],
        "sampled_X_rows": [rng.normal(size=(2, M)).tolist()
                           for _ in range(REPS)],
    }


def _params(**over):
    base = dict(n=N, m=M, d=2, p=0.3, lr=1e-3, weight_decay=1e-5,
                num_epochs=EPOCHS, reps=REPS, s=5.0, K=1, d1=None,
                strategy="random", popularity_method="zipf", alpha=1.5,
                soft_label=False, generation="base")
    base.update(over)
    return base


def _dump(folder, name, grid):
    rng = np.random.default_rng(0)
    data = [{"params": _params(**over), "results": _cell_results(rng)}
            for over in grid]
    path = os.path.join(folder, name)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Every pickle the figure cases read, and an output folder."""
    d = str(tmp_path_factory.mktemp("viz"))
    pk = {
        "s_p": _dump(d, "s_p.pkl", [dict(s=s, p=p, weight_decay=wd)
                                    for s in (0.5, 5.0) for p in (0.2, 0.4)
                                    for wd in (1e-5, 1e-3)]),
        "s_k": _dump(d, "s_k.pkl", [dict(s=s, K=k) for s in (0.5, 5.0)
                                    for k in (1, 10)]),
        "s": _dump(d, "s.pkl", [dict(s=s) for s in (0.1, 5.0, 100.0)]),
        "p_k": _dump(d, "p_k.pkl", [dict(p=p, K=k) for p in (0.05, 0.2)
                                    for k in (1, 5)]),
        "ps": _dump(d, "ps_const.pkl", [dict(p=p, s=s) for p, s in (
            (0.05, 10.0), (0.1, 5.0), (0.25, 2.0), (0.5, 1.0))]),
        "p_d": _dump(d, "p_d.pkl", [dict(p=p, d=dd) for p in (0.2, 0.4)
                                    for dd in (2, 4)]),
    }
    for strat in ("random", "proximity"):
        _dump(d, f"run_vs_s_K1_{strat}.pkl",
              [dict(s=s, strategy=strat) for s in (0.5, 5.0)])
        _dump(d, f"run_vs_p_{strat}.pkl",
              [dict(p=p, strategy=strat) for p in (0.05, 0.2)])
    for gen in ("gmm", "clustered"):
        _dump(d, f"gen_{gen}.pkl",
              [dict(s=s, generation=gen) for s in (0.5, 5.0)])
    g = np.random.default_rng(1)
    gt = [{"params": _params(p=p, K=k),
           "results": {"gt_loss": [0.2] * REPS,
                       "gt_accuracy": list(g.uniform(0.6, 0.9, REPS))}}
          for p in (0.01, 0.1) for k in (1, 10)]
    gt_d = [{"params": _params(d=dd, s=s),
             "results": {"gt_loss": [0.2] * REPS,
                         "gt_accuracy": list(g.uniform(0.6, 0.9, REPS))}}
            for dd in (1, 2, 3) for s in (1, 3)]
    for name, rows in (("gt", gt), ("gt_d", gt_d)):
        pk[name] = os.path.join(d, f"{name}.pkl")
        with open(pk[name], "wb") as f:
            pickle.dump(rows, f)
    # One pickle from the port's own scan on the CPU (s x wd, 2 reps).
    pk["scan"] = os.path.join(d, "scan.pkl")
    mfcd_tpu_torch.parameter_scan(
        device="cpu", n=24, m=28, d=2, p=0.4, s=[0.5, 5.0],
        weight_decay=[1e-5, 1e-3], num_epochs=2, reps=2,
        save_path=pk["scan"])
    pk["strat_s"] = os.path.join(d, "run_vs_s_K1_*.pkl")
    pk["strat_p"] = os.path.join(d, "run_vs_p_*.pkl")
    pk["gen"] = os.path.join(d, "gen_*.pkl")
    pk["out"] = os.path.join(d, "figs")
    return pk


# --- what a figure draws ------------------------------------------------


def _arr(x):
    return np.ma.filled(np.ma.asarray(x, dtype=float), np.nan)


def _drawn(fig):
    axes = []
    for ax in fig.get_axes():
        leg = ax.get_legend()
        axes.append(dict(
            title=ax.get_title(), xlabel=ax.get_xlabel(),
            ylabel=ax.get_ylabel(),
            zlabel=ax.get_zlabel() if hasattr(ax, "get_zlabel") else None,
            scales=(ax.get_xscale(), ax.get_yscale()),
            lines=[(_arr(ln.get_xdata()), _arr(ln.get_ydata()))
                   for ln in ax.get_lines()],
            collections=[(_arr(c.get_offsets()),
                          [_arr(p.vertices) for p in c.get_paths()])
                         for c in ax.collections],
            bars=[_arr([p.get_x(), p.get_y(), p.get_width(), p.get_height()])
                  for p in ax.patches if hasattr(p, "get_height")],
            images=[_arr(im.get_array()) for im in ax.get_images()],
            texts=[t.get_text() for t in ax.texts],
            ticks=([t.get_text() for t in ax.get_xticklabels()],
                   [t.get_text() for t in ax.get_yticklabels()]),
            legend=[t.get_text() for t in leg.get_texts()] if leg else None,
        ))
    sup = fig._suptitle.get_text() if fig._suptitle is not None else None
    return dict(suptitle=sup, axes=axes,
                fig_legends=[t.get_text() for lg in fig.legends
                             for t in lg.get_texts()])


def _equal(a, b, where="drawn"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _run(monkeypatch, case, pkg, data):
    """Call ``case`` through ``pkg``: (figures saved, returned value,
    standard output)."""
    saved = []

    def savefig(fig, fname, *args, **kwargs):
        saved.append((str(fname), _drawn(fig)))

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    monkeypatch.setattr(plt, "show", lambda *a, **k: None)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            ret = case(pkg, data)
    finally:
        plt.close("all")
        monkeypatch.undo()
    return saved, ret, out.getvalue()


# --- the cases: each takes (package modules, data) ------------------------


def _fig_path(data, name):
    return os.path.join(data["out"], name)


def _helpers(pkg, data):
    p = pkg["plots"]
    res = _viz_results()
    names = ["proximity", "margin", "top_k", "gt_accuracy", "some_new_metric",
             "weight_decay", "s"]
    out = [[p.format_display_name(n) for n in names]]
    try:
        p.enable_latex(True)
        out.append([p.format_display_name(n) for n in names])
    finally:
        p.enable_latex(False)
    out.append([p.smart_formatter(v) for v in
                (0, 0.5, 2.0, 1e-5, 3.3e-4, 1234.5, -0.02, 1e6)])
    out.append(p.assign_gradient_colors(["a", "b", "c"]))
    out.append(p.find_varying_params(res))
    out.append(p.find_fixed_indices(res, "p", "s"))
    out.append(p.find_fixed_indices(res, "p", "s",
                                    ignored_keys=["weight_decay"]))
    out.append(p.enrich_params_with_data_points(res)[0]["params"])
    return out


def _printers(pkg, data):
    p = pkg["plots"]
    res = _viz_results()
    p.display_experiment_indices(res[:3])
    p.print_results(res, indices=[0, 2])
    p.print_results(res, params_off=True, metric="pearson_corr")
    return [p.get_best_params(res, "accuracy"),
            p.get_best_params(res, "reconstruction_errors"),
            p.get_best_params_all_metrics(res)]


def _format_ticks(pkg, data):
    fig, ax = plt.subplots()
    ax.plot([1e-3, 0.5, 20.0, 4e3], [0.0, 2.5, 1e-4, 7.0])
    ax.set_xscale("log")
    pkg["plots"].format_ticks_smart(ax, "x")
    pkg["plots"].format_ticks_smart(ax, "y")
    fig.savefig(_fig_path(data, "ticks.png"))


def _losses(pkg, data):
    p = pkg["plots"]
    res = _viz_results()
    p.plot_losses(res, param_index=0, save_path=_fig_path(data, "l"),
                  show_plot=False)
    p.plot_losses(res, save_path=_fig_path(data, "la"), show_plot=False)
    p.plot_losses(res, selected_indices=[1, 3],
                  save_path=_fig_path(data, "ls"), show_plot=False)


def _heatmaps(pkg, data):
    p = pkg["plots"]
    res = _viz_results()
    for i, kw in enumerate((dict(), dict(overall=False, invert_x=True),
                            dict(log_scale=True, invert_colors=True,
                                 invert_y=True, font_scale=1.5))):
        p.plot_heatmap_best_fixed(res, "p", "s", "accuracy",
                                  save_path=_fig_path(data, f"hb{i}"),
                                  show_plot=False, **kw)
    p.plot_heatmap_best_fixed(res, "p", "s", "reconstruction_errors",
                              save_path=_fig_path(data, "hbl"),
                              show_plot=False)
    p.plot_heatmap_fixed(res, "p", "s", "accuracy", 1,
                         save_path=_fig_path(data, "hf"), show_plot=False)
    p.plot_multiple_heatmaps(res, "p", "s", "accuracy",
                             save_path=_fig_path(data, "hm"),
                             show_plot=False)
    p.plot_multiple_heatmaps(res, "p", "s", "accuracy", fixed_indices=[0],
                             save_path=_fig_path(data, "hm1"),
                             show_plot=False)
    p.plot_all_heatmaps(res, "p", "s", "accuracy",
                        save_path=_fig_path(data, "ha"), show_plot=False)
    p.plot_all_heatmaps(res, "s", "weight_decay", "accuracy", max_=True,
                        save_path=_fig_path(data, "hx"), show_plot=False)


def _scatter_3d(pkg, data):
    res = _viz_results()
    for use_plotly in (True, False):   # no plotly here: both take the
        pkg["plots"].plot_3d_scatter(   # matplotlib fallback
            res, "p", "s", "weight_decay", "accuracy",
            use_plotly=use_plotly,
            save_path=_fig_path(data, f"sc{use_plotly}"), show_plot=False)


def _metrics_vs_param(pkg, data):
    p = pkg["plots"]
    res = _viz_results()
    variants = (
        dict(param_x="p", metrics=["accuracy"], group_by="s",
             split_by="weight_decay"),
        dict(param_x="s", metrics=["accuracy", "pearson_corr"],
             group_by="p", log_scale_x=True, max_overall=True),
        dict(param_x="s", metrics="reconstruction_errors", group_by="p",
             fill_between=True, log_scale_y=True, title="T"),
        dict(param_x="p", metrics=["accuracy"], split_by="s",
             sub_plot=False, dashed=True, use_color_gradient=False),
        dict(param_x="s", metrics=["accuracy"], group_by=["p", "weight_decay"],
             line=True, ylim=(0.4, 1.0), GT_plot=False, grid=False),
        dict(param_x="s", metrics=["accuracy"], group_by="p",
             stds="pearson_corr", font_scale=1.5),
    )
    for i, kw in enumerate(variants):
        p.plot_metrics_vs_param(res, save_path=_fig_path(data, f"mv{i}"),
                                show_plot=False, **kw)


def _optimal(pkg, data):
    p = pkg["plots"]
    res = _viz_results()
    p.plot_optimal_param_vs_x(res, "s", "weight_decay", "accuracy",
                              group_by="p", save_path=_fig_path(data, "o1"),
                              show_plot=False)
    p.plot_optimal_param_vs_x(res, "p", "s", "reconstruction_errors",
                              log_scale_x=True, log_scale_y=True, title="T",
                              save_path=_fig_path(data, "o2"),
                              show_plot=False)


def _histograms(pkg, data):
    p = pkg["plots"]
    res = _viz_results()
    p.plot_histograms_from_results(res, "slopes", group_by="s",
                                   save_path=_fig_path(data, "h1"),
                                   show_plot=False)
    p.plot_histograms_from_results(res, "accuracy", group_by="p",
                                   split_by="weight_decay", error_type="sem",
                                   title="T", save_path=_fig_path(data, "h2"),
                                   show_plot=False)
    p.plot_histograms_from_results(res, "pearson_corr", error_type="std",
                                   log_y=True, bins_num=4,
                                   save_path=_fig_path(data, "h3"),
                                   show_plot=False)


def _report(pkg, data):
    r = pkg["report"]
    res = _viz_results()
    rng = np.random.default_rng(0)
    r.plot_sampled_comparison_aligned(
        rng.normal(size=50), rng.normal(size=50), title="row",
        save_path=_fig_path(data, "cmp.png"), show_plot=False)
    r.plot_alpha_vs_s(res, s_min=0.01, s_max=100,
                      weight_decays=(1e-5, 1e-3),
                      save_path=_fig_path(data, "avs"), show_plot=False)
    return [r.shift_color("tab:red"), r.shift_color((0.5, 0.5, 0.5), 1.5),
            r.find_closest_index_by_s(res, 4.9),
            r.find_closest_index_by_s(res, 0.0),
            r.aggregate_by_param(res, "p"), r.aggregate_by_param(res, "s"),
            r.plot_outlier_impact(save_path=_fig_path(data, "outl"),
                                  show_plot=False)]


def _s_sweep(pkg, data):
    pkg["exp"].s_sweep_figures(data["s_p"], outdir=data["out"])
    pkg["exp"].s_sweep_figures(data["s_k"], outdir=data["out"])


def _per_row(pkg, data):
    pkg["exp"].per_row_diagnostics(data["s"], outdir=data["out"])


def _p_sweep(pkg, data):
    e = pkg["exp"]
    e.p_sweep_figures(data["p_k"], outdir=data["out"])
    e.p_sweep_figures(data["p_k"], outdir=data["out"], derived=("pxK",))
    e.p_sweep_figures(data["ps"], outdir=data["out"], derived=("p*s",),
                      tag="ps_const")


def _strategy_generation(pkg, data):
    e = pkg["exp"]
    e.strategy_figures(data["strat_s"], outdir=data["out"])
    e.strategy_figures(data["strat_p"], outdir=data["out"])
    e.generation_figures(data["gen"], outdir=data["out"])


def _gt(pkg, data):
    pkg["exp"].gt_figures(data["gt"], outdir=data["out"])
    pkg["exp"].gt_figures(data["gt_d"], outdir=data["out"])


def _losses_heatmaps(pkg, data):
    e = pkg["exp"]
    e.loss_curves(data["s_p"], outdir=data["out"])
    e.heatmaps(data["s_p"], outdir=data["out"])
    e.heatmaps(data["p_d"], outdir=data["out"], param_x="p", param_y="d")
    with pytest.raises(ValueError, match="single value"):
        e.heatmaps(data["s"], outdir=data["out"])


def _cli(pkg, data):
    e = pkg["exp"]
    rcs = [e.main(["--list"]),
           e.main(["p_sweep_figures", "--pickle", data["ps"], "--outdir",
                   data["out"], "--derived", "p*s", "--tag", "cli"]),
           e.main(["heatmaps", "--pickle", data["p_d"], "--outdir",
                   data["out"], "--param-x", "p", "--param-y", "d"])]
    return rcs, sorted(e.ALL)


def _scan_pickle(pkg, data):
    """The figures of one pickle written by the port's CPU scan."""
    e = pkg["exp"]
    e.s_sweep_figures(data["scan"], outdir=data["out"])
    e.per_row_diagnostics(data["scan"], outdir=data["out"],
                          s_targets=(0.5, 5.0))
    e.loss_curves(data["scan"], outdir=data["out"])
    e.heatmaps(data["scan"], outdir=data["out"], param_x="s",
               param_y="weight_decay")
    with open(data["scan"], "rb") as f:
        res = pickle.load(f)
    pkg["plots"].plot_metrics_vs_param(
        res, "s", ["accuracy", "gt_accuracy"], group_by="weight_decay",
        log_scale_x=True, save_path=_fig_path(data, "scan_acc"),
        show_plot=False)
    pkg["plots"].plot_histograms_from_results(
        res, "alpha_per_row", group_by="s", split_by="weight_decay",
        save_path=_fig_path(data, "scan_hist"), show_plot=False)
    return pkg["plots"].get_best_params_all_metrics(res)


CASES = {f.__name__.lstrip("_"): f for f in (
    _helpers, _printers, _format_ticks, _losses, _heatmaps, _scatter_3d,
    _metrics_vs_param, _optimal, _histograms, _report, _s_sweep, _per_row,
    _p_sweep, _strategy_generation, _gt, _losses_heatmaps, _cli,
    _scan_pickle)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_draws_what_jax_draws(name, data, monkeypatch):
    case = CASES[name]
    want = _run(monkeypatch, case, JAX, copy.deepcopy(data))
    got = _run(monkeypatch, case, PORT, copy.deepcopy(data))
    saved_want, ret_want, out_want = want
    saved_got, ret_got, out_got = got
    assert [f for f, _ in saved_got] == [f for f, _ in saved_want]
    for (fname, a), (_, b) in zip(saved_want, saved_got):
        _equal(a, b, fname)
    _equal(ret_want, ret_got, "returned")
    assert out_got == out_want
    if name not in ("helpers", "printers"):
        assert saved_got, "the case saved no figure"


def test_every_public_function_is_covered():
    """Each public name of the three figure modules is the same object
    kind in both packages, and each plotting one is called above."""
    import inspect

    with open(__file__) as f:
        src = f.read()
    for jmod, tmod in ((jplots, tplots), (jreport, treport), (jexp, texp)):
        public = {n for n, v in vars(jmod).items()
                  if inspect.isfunction(v) and not n.startswith("_")
                  and v.__module__ == jmod.__name__}
        assert public == {n for n, v in vars(tmod).items()
                          if inspect.isfunction(v) and not n.startswith("_")
                          and v.__module__ == tmod.__name__}
        for n in public - {"main"}:
            assert f".{n}(" in src, n
