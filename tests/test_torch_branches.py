"""PyTorch port, whole-trace parity on the config branches that the JAX
package's own end-to-end tests take (``tests/test_driver.py``): the Matern
kernel, free endpoints, tuple kernel options, a degenerate short edge, two
non-square images, a trace that stops unconverged at ``max_iters``, and
``reference_quirks=False``, each at that test's shapes.

Each case runs the reference's ``run_trace`` and the port's on the
reference's data (``interop.from_reference``) and the reference's draws
(``torch_parity.JaxDraws``). The loop must accept the same pixels in the
same iterations. The reference's final fit is forced onto its batched LML
path (``optimize_lml(use_batched=True)``), the path of its TPU and the one
the port follows: on the CPU it would take its unbatched path, which ends
elsewhere along the LML's flat ridge (free endpoints: θ₀ 1.315 against the
batched 0.735). JAX keeps the first compile of a jitted function for a
config, so the module clears JAX's caches before and after it runs.

The final fit is held in three parts. At the reference's θ the port's
posterior gives the reference's mean within 1e-2 px (measured at most
7.5e-3, on 96×256). The two packages' optimisers, though, stop at
different points of the ridge in float32: from identical training sets
the optimised means part by 0.0114 (quirks off), 0.0206 (Matern), 0.0290
(free endpoints) and 0.0326 px (96×256), above the 1e-2 px the port was
meant to hold, and the LMLs by up to 0.036 (quirks off: 3.3027 against
the reference's 3.3388). So the optimised fit is held only to the repo's
bound for that ridge (``torch_parity.FINAL_FIT``, 0.1 px on the mean) and
the LMLs to 0.05 of each other. The witness for the cause is the third
part: the same screen and polish run in float64 in both packages, from
the same training set and starts, reach the same LML within 1e-6 and the
same θ within 1.1e-7 (where θ is identified), while in float32 they part
by up to 1.83 in θ and 0.18 in LML. Their damped-Newton polish takes a
Hessian from central differences (h = 1e-3) of float32 gradients, so the
rounding of two float32 LML implementations, not a difference of
algorithm, moves where four steps stop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_tpu.trace import driver as rd
from gaussian_process_edge_trace_tpu.utils.image import (
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img
from torch_parity import FINAL_FIT, JaxDraws

torch.set_num_threads(1)


def _demo_setup(size=(128, 128)):
    """``tests/test_driver.py::_demo_setup``: (grad, init) of a sinusoidal
    edge, endpoints at both ends."""
    img, edge = construct_test_img(
        size=size, amplitude=40, curvature=2, noise_level=0.02,
        ltype="sinusoidal", intensity=0.3, gaps=False)
    grad = np.asarray(comp_grad_img(img, kernel_builder(size=(9, 5),
                                                        unit=False)),
                      dtype=np.float64)
    N = size[1]
    return grad, np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])


# test_driver.py's _run settings: RBF σf 30, ℓ 10, S = 200, δx = 6.
RUN_KW = dict(noise_y=1, N_samples=200, score_thresh=0.5, delta_x=6,
              keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
RBF = {"kernel": "RBF", "sigma_f": 30, "length_scale": 10}


def _short_edge():
    """test_driver.py:229: the span is shorter than δx, so the loop never
    runs and the final fit sees the two inits alone."""
    grad = np.random.RandomState(0).uniform(0, 1, (32, 32))
    return grad, np.array([[10, 16], [13, 17]]), dict(
        kernel_options={"kernel": "RBF", "sigma_f": 8, "length_scale": 3},
        noise_y=1, N_samples=120, score_thresh=0.5, delta_x=20,
        keep_ratio=0.25, pixel_thresh=2, seed=0, fix_endpoints=True)


def _no_edge():
    """test_driver.py:278: no edge near the inits. At that test's
    ``max_iters`` = 4 the reference converges in 3 iterations here, so
    ``max_iters`` = 2 stops the trace unconverged."""
    grad = np.zeros((64, 64))
    grad[2, :] = 1.0
    return grad, np.array([[0, 60], [63, 60]]), dict(
        kernel_options={"kernel": "RBF", "sigma_f": 4, "length_scale": 20},
        noise_y=1, N_samples=120, score_thresh=1.0, delta_x=4,
        keep_ratio=0.25, pixel_thresh=5, seed=0, fix_endpoints=True,
        max_iters=2)


def _demo(size=(128, 128), **kw):
    return lambda: (*_demo_setup(size), dict(RUN_KW, **kw))


# Case → () -> (grad, init, make_config kwargs), test_driver.py's line.
CASES = {
    "matern": _demo(kernel_options={"kernel": "Matern", "sigma_f": 30,
                                    "length_scale": 10, "nu": 2.5}),  # :130
    "free_endpoints": _demo(kernel_options=RBF, fix_endpoints=False),  # :166
    "tuple_options": _demo(kernel_options=(0, 4, 4)),                 # :185
    "short_edge": _short_edge,                                        # :229
    "non_square_96x256": _demo((96, 256), kernel_options=dict(
        RBF, length_scale=max(10, 256 // 24))),                       # :253
    "non_square_256x96": _demo((256, 96), kernel_options=dict(
        RBF, length_scale=max(10, 96 // 24))),                        # :253
    "unconverged": _no_edge,                                          # :278
    "quirks_off": _demo(kernel_options=RBF, reference_quirks=False),  # :343
}


def replay(case):
    """The reference's trace of ``case`` and the port's from the same data
    and draws: ``(cfg, ref, got, pcfg, pdata, fit)``, where ``fit`` holds
    the arguments of the port's final-fit ``optimize_lml`` call."""
    grad, init, kw = CASES[case]()
    cfg = rd.make_config(init, grad.shape, **kw)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    ref = jax.device_get(rd.run_trace(cfg, data, state0))
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    fit, optimize_lml = {}, pd.optimize_lml

    def capture(*args, **kw):
        fit.update(args=args, kw=kw)
        return optimize_lml(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd, "optimize_lml", capture)
        got = pd.run_trace(pcfg, pdata, pstate0, draws=JaxDraws(
            pcfg, pdata.L_prior_unit.shape[1]))
    return cfg, ref, got, pcfg, pdata, fit


def optimise_both(cfg, fit, dtype):
    """Both packages' batched optimisers on the port's final-fit inputs
    ``fit`` (see :func:`replay`), the starts and bounds in ``dtype``
    ("float32" or "float64"): ``((θ, LML) of the port, (θ, LML) of the
    reference)`` as numpy arrays and floats."""
    kernel, xs, ys, mask, noise_w, starts, lb, ub = fit["args"]
    row = [t.reshape(-1, t.shape[-1])[0].numpy() for t in (xs, ys, mask,
                                                           noise_w)]
    th_r, lml_r = rd.optimize_lml(
        cfg.kernel, *map(jnp.asarray, row),
        *(jnp.asarray(t.numpy(), dtype) for t in (starts, lb, ub)),
        use_batched=True, **fit["kw"])
    th_p, lml_p = pd.optimize_lml(
        kernel, xs, ys, mask, noise_w,
        *(t.to(getattr(torch, dtype)) for t in (starts, lb, ub)),
        **fit["kw"])
    return ((th_p.reshape(-1).numpy(), float(lml_p.reshape(()))),
            (np.asarray(th_r), float(lml_r)))


@pytest.fixture(scope="module")
def traces():
    """Per case, lazily, :func:`replay` with the reference's final fit on
    its batched path."""
    mp = pytest.MonkeyPatch()
    mp.setattr(rd, "optimize_lml",
               functools.partial(rd.optimize_lml, use_batched=True))
    jax.clear_caches()
    done = {}

    def get(case):
        if case not in done:
            done[case] = replay(case)
        return done[case]
    yield get
    mp.undo()
    jax.clear_caches()


def _mean_at(cfg, got, pcfg, pdata, theta):
    """The port's posterior mean (pixels) on its own training set with the
    LML's optimum replaced by ``theta``."""
    theta = torch.as_tensor(theta, dtype=torch.float32).reshape(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd, "optimize_lml", lambda kernel, xs, *a, **k: (
            theta.expand(xs.shape[:-1] + (3,)), torch.zeros(xs.shape[:-1])))
        pad = cfg.n_train - cfg.n_inits - cfg.bins.n_bins
        zeros = torch.zeros(pad, dtype=torch.int64)
        return pd._final_fit_buffers(
            pcfg, pdata, torch.zeros((cfg.lml_restarts, 3)),
            torch.cat([pdata.init_x, got.obs_x, zeros]),
            torch.cat([pdata.init_y, got.obs_y, zeros]),
            torch.cat([torch.ones(cfg.n_inits, dtype=torch.bool),
                       got.obs_valid, torch.zeros(pad, dtype=torch.bool)]),
            torch.cat([torch.full((cfg.n_inits,), cfg.init_noise_weight),
                       torch.ones(cfg.n_train - cfg.n_inits)]))[0].numpy()


@pytest.mark.parametrize("case", CASES)
def test_trajectory_matches_reference(traces, case):
    """The same accepted pixels, per-iteration observation counts,
    iteration count and convergence as the reference, from its draws."""
    cfg, ref, got = traces(case)[:3]
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert got.n_iters == int(ref.n_iters)
    assert got.converged == bool(ref.converged)
    # Each case takes its branch.
    if case == "short_edge":
        assert cfg.N_subints == 0 and got.n_iters == 0
    elif case == "unconverged":
        assert got.n_iters == cfg.max_iters and not got.converged
    else:
        assert got.n_iters >= 2 and got.converged
    if case.startswith("non_square"):
        assert cfg.M != cfg.N
    if case == "free_endpoints":
        assert cfg.init_noise_weight == 0.5
    if case == "tuple_options":
        assert cfg.kernel.kind == "RBF" and cfg.sigma_f == 128 // 4


@pytest.mark.parametrize("case", CASES)
def test_final_fit_matches_batched_reference(traces, case):
    """The final fit against the reference's batched path. At the
    reference's θ, with ``test_torch_slice.py``'s tolerances: the mean
    within 1e-2 px, and the integer trace equal wherever the reference's
    mean lies farther than that from a rounding boundary. The port's own
    optimised fit: the mean within ``FINAL_FIT``'s 0.1 px and the
    pixel-unit interval within its 0.15 px, the integer trace equal where
    the mean lies farther than 0.1 px from a rounding boundary, the LML
    within 0.05 (see the module's note); without the quirks both of its
    intervals are in pixels and equal."""
    cfg, ref, got, pcfg, pdata = traces(case)[:5]
    mean = np.asarray(ref.y_mean)
    at_ref = _mean_at(cfg, got, pcfg, pdata, np.asarray(ref.theta))
    assert np.abs(at_ref - mean).max() < 1e-2
    far = np.abs(mean - np.floor(mean) - 0.5) > 1e-2
    np.testing.assert_array_equal(np.rint(at_ref)[far],
                                  np.asarray(ref.edge_trace)[far, 0])

    mean_tol = FINAL_FIT["y_mean"][1]
    assert np.abs(got.y_mean.numpy() - mean).max() < mean_tol
    assert np.abs(got.cred_interval_px.numpy()
                  - np.asarray(ref.cred_interval_px)).max() \
        < FINAL_FIT["cred_interval_px"][1]
    far = np.abs(mean - np.floor(mean) - 0.5) > mean_tol
    np.testing.assert_array_equal(got.edge_trace[:, 0].numpy()[far],
                                  np.asarray(ref.edge_trace)[far, 0])
    np.testing.assert_array_equal(got.edge_trace[:, 1].numpy(),
                                  np.asarray(ref.edge_trace)[:, 1])
    assert abs(float(got.lml) - float(ref.lml)) < 0.05
    if not cfg.reference_quirks:
        assert torch.equal(got.cred_interval, got.cred_interval_px)


@pytest.mark.parametrize("case", CASES)
def test_polish_agrees_in_float64(traces, case):
    """The witness for the optimised fit's gap: both packages' batched
    optimisers (screen, damped-Newton polish) run in float64 from the
    port's final-fit training set and starts. They reach the same LML
    within 1e-6 (measured at most 1.7e-8), and the port's float32
    posterior means at their two optima agree within the 1e-2 px that the
    float32 optimised fits miss (measured 2.3e-3 px on 96×256, whose θ
    part by 1.1e-7; 0 elsewhere). The short edge fixes both endpoints, so
    the noise level does not enter its LML and its θ₂ is not identified:
    the LMLs and means agree, the θ₂ do not."""
    cfg, _, got, pcfg, pdata, fit = traces(case)
    (th_p, lml_p), (th_r, lml_r) = optimise_both(cfg, fit, "float64")
    assert th_p.dtype == th_r.dtype == np.float64
    assert abs(lml_p - lml_r) < 1e-6
    gap = np.abs(_mean_at(cfg, got, pcfg, pdata, th_r)
                 - _mean_at(cfg, got, pcfg, pdata, th_p)).max()
    assert gap < 1e-2
