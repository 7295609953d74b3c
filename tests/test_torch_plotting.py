"""PyTorch port, the host-side matplotlib diagnostics (``utils/plotting.py``)
and the tracer's plotting options, under Agg: the counterpart of
``tests/test_plotting.py``. The figures are built from numpy arrays and
from CPU tensors; ``show_init_post`` aborts on "n" and goes on after "y";
``print_final_diagnostics`` and ``show_post_iter`` each build their
figures, and the traced result is the plain call's, bit for bit."""

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from gaussian_process_edge_trace_torch import GP_Edge_Tracing  # noqa: E402
from gaussian_process_edge_trace_torch.utils import plotting  # noqa: E402
from gaussian_process_edge_trace_torch.utils.image import (  # noqa: E402
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_torch.utils.synthetic import (  # noqa: E402
    construct_test_img)

torch.set_num_threads(1)


def _setup(size=(64, 64)):
    img, edge = construct_test_img(size=size, amplitude=20, curvature=2,
                                   noise_level=0.01, ltype="sinusoidal",
                                   intensity=0.3, gaps=False)
    grad = comp_grad_img(img, kernel_builder((7, 3)), device="cpu").numpy()
    N = size[1]
    init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    return img, grad, edge, init


def _tracer(grad, init, **kw):
    return GP_Edge_Tracing(
        init, grad,
        kernel_options={"kernel": "RBF", "sigma_f": 18, "length_scale": 6},
        noise_y=1, N_samples=120, score_thresh=0.5, delta_x=5,
        keep_ratio=0.25, pixel_thresh=4, seed=7, fix_endpoints=True,
        device="cpu", **kw)


@pytest.fixture
def figures(monkeypatch):
    """Count the figures each plotting function builds; ``plt.show`` does
    nothing."""
    monkeypatch.setattr(plt, "show", lambda: None)
    made = []
    for name in ("plot_iter", "plot_diagnostics", "plot_results"):
        fn = getattr(plotting, name)
        monkeypatch.setattr(plotting, name, lambda *a, _f=fn, _n=name, **k:
                            made.append((_n, _f(*a, **k))) or made[-1][1])
    yield made
    plt.close("all")


@pytest.mark.parametrize("as_tensor", [False, True])
def test_plot_functions_build_figures(as_tensor):
    img, grad, edge, init = _setup()
    E = grad.shape[1]
    wrap = torch.tensor if as_tensor else np.asarray
    x_grid = np.arange(E)
    samples = 30 + 5 * np.random.RandomState(0).standard_normal((E, 25))
    fig1 = plotting.plot_iter(wrap(x_grid), wrap(samples), 10,
                              np.zeros((0, 2)), init, grad.shape, show=False)
    curves = [np.stack([x_grid, samples[:, i]], axis=1) for i in range(3)]
    fig2 = plotting.plot_diagnostics(
        wrap(grad), x_grid, [wrap(c) for c in curves],
        [torch.tensor(3.0), 2.0, 1.5],
        credint=(wrap(samples[:, 0] - 2), wrap(samples[:, 0] + 2)),
        show=False)
    pred = np.stack([edge[:E, 0], x_grid], axis=1)
    fig3 = plotting.plot_results(wrap(pred), edge[:E], img, wrap(grad),
                                 credint=(edge[:E, 0] - 2.0,
                                          edge[:E, 0] + 2.0), show=False)
    for f in (fig1, fig2, fig3):
        assert isinstance(f, matplotlib.figure.Figure) and f.axes
    assert "DICE: 1.0" in fig3.axes[1].get_title()
    plt.close("all")


def test_verbose_and_final_diagnostics(figures, capsys):
    """``print_final_diagnostics`` with ``verbose`` builds the diagnostics
    figure (one curve per iteration and the trace) and gives the plain
    call's trace."""
    _, grad, edge, init = _setup()
    tracer = _tracer(grad, init)
    plain = tracer()
    out = tracer(print_final_diagnostics=True, verbose=True)
    np.testing.assert_array_equal(out, plain)
    assert out.shape == (tracer.edge_length, 2)
    text = capsys.readouterr().out
    assert "Number of observations" in text and "Time elapsed" in text
    assert [n for n, _ in figures] == ["plot_diagnostics"]
    n = tracer.last_result.n_iters
    assert len(figures[0][1].axes[0].get_lines()) == n + 1


def test_final_diagnostics_on_the_fused_path(figures):
    _, grad, edge, init = _setup()
    tracer = _tracer(grad, init)
    plain = tracer()
    np.testing.assert_array_equal(tracer(print_final_diagnostics=True),
                                  plain)
    assert [n for n, _ in figures] == ["plot_diagnostics"]


def test_show_init_post_abort(figures, monkeypatch):
    monkeypatch.setattr("builtins.input", lambda: "n")
    _, grad, edge, init = _setup()
    tracer = _tracer(grad, init)
    # The reference returns None when the user rejects the kernel preview
    # (gpet.py:809-812).
    assert tracer(show_init_post=True) is None
    assert [n for n, _ in figures] == ["plot_iter"]


def test_show_init_post_continue(figures, monkeypatch):
    """After a "y" the trace goes on, with ``show_post_iter`` one fan chart
    per iteration: the plain call's trace; with ``return_lines`` the
    initial posterior's curves come first."""
    monkeypatch.setattr("builtins.input", lambda: "y")
    _, grad, edge, init = _setup()
    tracer = _tracer(grad, init)
    plain = tracer()
    out = tracer(show_init_post=True, show_post_iter=True)
    np.testing.assert_array_equal(out, plain)
    n = tracer.last_result.n_iters
    assert [n_ for n_, _ in figures] == ["plot_iter"] * (n + 1)
    _, (samples, obs, curves) = tracer(show_init_post=True,
                                       return_lines=True)
    assert len(samples) == n + 2 and len(obs) == n + 2
    assert samples[0].shape == (tracer.edge_length, tracer.N_samples)


def test_show_post_iter_refuses_an_ensemble():
    _, grad, edge, init = _setup()
    with pytest.raises(ValueError, match="show_post_iter"):
        _tracer(grad, init)(show_post_iter=True, ensemble=2)


def test_plotting_without_matplotlib_names_it(monkeypatch):
    import sys
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plotting.plot_iter(np.arange(4), np.zeros((4, 2)), 1,
                           np.zeros((0, 2)), np.zeros((2, 2)), (4, 4))
