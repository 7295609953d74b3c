"""PyTorch port, the reference-compatible API: ``ops/diff.py``,
``ops/interp.py``, ``trace_relarea``, ``gp_predict_mean`` and
``gp_predict(return_cov=True)``, the driver's ``trace_step``,
``preview_samples``, ``sample_round_buffers`` and ``final_fit_buffers``,
the tracer's introspective ``__call__`` and its per-stage methods, the
unbatched ``screen_and_polish``, and the alias modules, each against the
JAX package on the same numpy inputs (the small slice config)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.interpolate import RectBivariateSpline

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.models import gpr as pgpr
from gaussian_process_edge_trace_torch.models.kernels import KernelSpec
from gaussian_process_edge_trace_torch.ops.diff import finite_diff
from gaussian_process_edge_trace_torch.ops.interp import bilinear_interp
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_tpu import GP_Edge_Tracing as RefTracer
from gaussian_process_edge_trace_tpu.models import gpr as rgpr
from gaussian_process_edge_trace_tpu.models.kernels import (
    KernelSpec as RefKernelSpec)
from gaussian_process_edge_trace_tpu.ops.diff import (
    finite_diff as ref_finite_diff)
from gaussian_process_edge_trace_tpu.ops.interp import (
    bilinear_interp as ref_bilinear_interp)
from gaussian_process_edge_trace_tpu.trace import driver as rd
from gaussian_process_edge_trace_tpu.utils.metrics import (
    trace_relarea as ref_relarea)
from torch_parity import (SMALL_KW, JaxDraws, JaxKeyDraws, assert_same_bits,
                          small_problem)

torch.set_num_threads(1)

# The sampling round's curves and the loop's optimal curves: the tolerance
# of test_torch_slice.py's trajectory test (f32 sums in other orders).
SAMPLES_RTOL, SAMPLES_ATOL = 1e-4, 1e-3


def _tracers(**kw):
    """The JAX package's tracer and the port's on the small config."""
    _, edge, grad, init = small_problem()
    args = dict(SMALL_KW, **kw)
    return (RefTracer(init, grad, **args),
            gpt.GP_Edge_Tracing(init, grad, device="cpu", **args), edge)


def _rank(tracer):
    return tracer.data.L_prior_unit.shape[1]


# -- ops and metrics ---------------------------------------------------------

@pytest.mark.parametrize("typ", [0, 1, 2])
@pytest.mark.parametrize("h", [1, 2, 3])
def test_finite_diff_matches_reference(typ, h):
    """Exactly the JAX function's values, out-of-range gathers (h > 1)
    included."""
    v = np.random.default_rng(typ * 10 + h).normal(size=17)
    np.testing.assert_array_equal(finite_diff(torch.tensor(v), typ, h)
                                  .numpy(), np.asarray(ref_finite_diff(
                                      jnp.asarray(v), typ, h)))


def test_bilinear_interp_matches_reference_and_scipy():
    """Float64, queries inside and outside the grid: the JAX function and
    scipy's ``RectBivariateSpline(kx=1, ky=1)`` within 1e-12."""
    rng = np.random.default_rng(3)
    img = rng.random((13, 17))
    rows = rng.uniform(-3, 16, 200)
    cols = rng.uniform(-3, 20, 200)
    got = bilinear_interp(torch.tensor(img), torch.tensor(rows),
                          torch.tensor(cols)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(ref_bilinear_interp(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols))),
        rtol=0, atol=1e-12)
    spline = RectBivariateSpline(np.arange(13), np.arange(17), img, kx=1,
                                 ky=1)
    np.testing.assert_allclose(got, spline(rows, cols, grid=False), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_relarea_matches_reference(seed):
    rng = np.random.default_rng(seed)
    true = np.stack([rng.integers(0, 60, 80), np.arange(80)], axis=1)
    pred = true.copy()
    pred[:, 0] += rng.integers(-5, 6, 80)
    assert gpt.trace_relarea(pred, true) == float(ref_relarea(pred, true))
    assert gpt.gpet_utils.trace_relarea(true, true) == 0.0


def test_gp_predict_mean_and_cov_match_reference():
    """``gp_predict_mean`` and ``gp_predict(return_cov=True)`` in float64
    on a masked fit, against the JAX functions within 1e-10."""
    rng = np.random.default_rng(4)
    n = 16
    x = np.sort(rng.uniform(0, 30, n))
    y = np.sin(x / 4) * 5
    mask = np.ones(n, bool)
    mask[-3:] = False
    dn = np.full(n, 0.1)
    xq = np.linspace(-2, 32, 25)
    ref = rgpr.gp_fit(RefKernelSpec("Matern", 1.5), jnp.asarray(x),
                      jnp.asarray(y), 3.0, 2.0, jnp.asarray(dn),
                      jnp.asarray(mask))
    got = pgpr.gp_fit(KernelSpec("Matern", 1.5), torch.tensor(x),
                      torch.tensor(y), 3.0, 2.0, torch.tensor(dn),
                      torch.tensor(mask))
    spec = KernelSpec("Matern", 1.5)
    np.testing.assert_allclose(
        pgpr.gp_predict_mean(spec, got, torch.tensor(xq), 3.0, 2.0).numpy(),
        np.asarray(rgpr.gp_predict_mean(RefKernelSpec("Matern", 1.5), ref,
                                        jnp.asarray(xq), 3.0, 2.0)),
        rtol=1e-10, atol=1e-10)
    m, cov = pgpr.gp_predict(spec, got, torch.tensor(xq), 3.0, 2.0,
                             return_cov=True)
    rm, rcov = rgpr.gp_predict(RefKernelSpec("Matern", 1.5), ref,
                               jnp.asarray(xq), 3.0, 2.0, return_cov=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(cov.numpy(), np.asarray(rcov), rtol=1e-10,
                               atol=1e-10)
    _, std = pgpr.gp_predict(spec, got, torch.tensor(xq), 3.0, 2.0,
                             return_std=True)
    np.testing.assert_allclose(std.numpy() ** 2,
                               np.clip(np.diag(cov.numpy()), 0, None),
                               rtol=1e-8, atol=1e-10)


# -- the tracer's attributes and per-stage methods ------------------------

def test_public_attributes_match_reference():
    ref, got, _ = _tracers(keep_ratio=1.5, N_samples=150)
    for a in ("keep_ratio", "N_keep", "N_samples", "algo_thresh",
              "score_thresh", "kde_thresh"):
        assert getattr(got, a) == getattr(ref, a), a
    np.testing.assert_array_equal(got.alpha_init, ref.alpha_init)
    np.testing.assert_allclose(got.grad_img, ref.grad_img, rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(got.grad_kde, ref.grad_kde, rtol=2e-5,
                               atol=2e-6)
    assert "X" not in got._host                     # built on first access
    np.testing.assert_array_equal(got.X, ref.X)
    assert got.X is got.X


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cost_funct_matches_reference(seed):
    """An arbitrary (non-grid, unsorted) edge: float64, relative 1e-10."""
    ref, got, edge = _tracers()
    rng = np.random.default_rng(seed)
    n = 40 + seed
    xs = rng.uniform(0, got.N - 1, size=n)
    ys = np.clip(edge[np.clip(xs.astype(int), 0, got.N - 1), 0]
                 + rng.normal(0, 2.0, size=n), 0, got.M - 1)
    e = np.stack([xs, ys], axis=1)
    np.testing.assert_allclose(got.cost_funct(e), ref.cost_funct(e),
                               rtol=1e-10)


def test_grad_interp_and_finite_diff_methods():
    ref, got, _ = _tracers()
    rng = np.random.default_rng(1)
    rows = rng.uniform(-2, got.M + 1, 50)
    cols = rng.uniform(-2, got.N + 1, 50)
    np.testing.assert_allclose(got.grad_interp(rows, cols),
                               ref.grad_interp(rows, cols), atol=1e-6)
    spline = RectBivariateSpline(np.arange(got.M), np.arange(got.N),
                                 got.grad_img.astype(np.float64), kx=1, ky=1)
    np.testing.assert_allclose(got.grad_interp(rows, cols),
                               spline(rows, cols, grid=False), atol=1e-12)
    r, c = np.sort(rows[:5]), np.sort(cols[:7])
    np.testing.assert_allclose(got.grad_interp(r, c, grid=True),
                               spline(r, c), atol=1e-12)
    v = rng.normal(size=17)
    np.testing.assert_array_equal(got.finite_diff(v), v[1:] - v[:-1])


def _manual_round(tracer, samples, pre_fobs_yx):
    curves, costs, opt = tracer.get_best_curves(samples)
    kde = tracer.kernel_density_estimate(curves, costs)
    fobs = tracer.get_best_pixels(curves, costs, pre_fobs_yx)
    return curves, costs, opt, kde, fobs


def test_one_manual_iteration_matches_reference():
    """The reference's stages driven one round the way gpet.py's
    ``__call__`` drives them (gpet.py:829-861), in both packages: the
    sampling round from the same key at the trajectory tolerance; then,
    from the same curves, the kept costs at the fused cost's bounds (line
    rel 1e-4, arc rel 1e-5, so the cost within 2e-4), the same kept curves,
    the same accepted pixels and the threshold kept on the tracer; a second
    round from the first's pixels, which sees that threshold;
    ``compute_new_obs`` with a candidate mask; and the gradient KDE."""
    ref, got, _ = _tracers()
    empty = np.zeros((0, 2), int)
    r_samples = ref.fit_predict_GP(empty, converged=False, seed=1)
    g_samples = got.fit_predict_GP(empty, converged=False, draws=JaxKeyDraws(
        got.cfg, _rank(got), jax.random.PRNGKey(1)))
    assert g_samples.shape == (got.edge_length, got.N_samples)
    np.testing.assert_allclose(g_samples, r_samples, rtol=SAMPLES_RTOL,
                               atol=SAMPLES_ATOL)

    fobs = {}
    for name, tracer in (("ref", ref), ("got", got)):
        curves, costs, opt, kde, fobs[name] = _manual_round(
            tracer, r_samples, empty)
        fobs[name + "_curves"], fobs[name + "_costs"] = curves, costs
        fobs[name + "_kde"] = kde
        fobs[name + "_opt"] = opt
    np.testing.assert_allclose(fobs["got_costs"], fobs["ref_costs"],
                               rtol=2e-4)
    np.testing.assert_array_equal(fobs["got_curves"], fobs["ref_curves"])
    np.testing.assert_array_equal(fobs["got_opt"][0], fobs["ref_opt"][0])
    np.testing.assert_allclose(fobs["got_kde"], fobs["ref_kde"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(fobs["got"], fobs["ref"])
    assert got.score_thresh == ref.score_thresh <= SMALL_KW["score_thresh"]

    # Round two from round one's pixels (yx, gpet.py:857): the decayed
    # threshold carries over.
    thresh1 = got.score_thresh
    s2 = ref.fit_predict_GP(fobs["ref"], converged=False, seed=2)
    out = {}
    for name, tracer in (("ref", ref), ("got", got)):
        out[name] = _manual_round(tracer, s2, fobs[name][:, [1, 0]])[-1]
    np.testing.assert_array_equal(out["got"], out["ref"])
    assert got.score_thresh == ref.score_thresh <= thresh1
    assert out["got"].shape[0] >= fobs["got"].shape[0]

    # compute_new_obs with explicit yx candidates (gpet.py:532-619).
    kde = fobs["ref_kde"]
    cand = np.argwhere(kde > got.kde_thresh)
    cand = cand[(cand[:, 1] > got.x_st) & (cand[:, 1] < got.x_en)]
    cand = cand[::3]
    np.testing.assert_array_equal(
        got.compute_new_obs(cand, kde, fobs["got"][:, [1, 0]]),
        ref.compute_new_obs(cand, kde, fobs["ref"][:, [1, 0]]))
    assert got.score_thresh == ref.score_thresh
    np.testing.assert_allclose(got.kernel_density_estimate(), got.grad_kde,
                               atol=0)


class _IterationDraws:
    """Iteration ``it``'s draws of a trace source as a buffer source: its
    prior normals, and the first ``n`` rows of its noise normals (the
    training slots that the inits hold first in both layouts)."""

    def __init__(self, draws, it):
        self.z, self.w = draws.normals(it)

    def sample_normals(self, n):
        return self.z, self.w[:n]


def test_stages_from_the_first_iterations_draws_equal_trace_step():
    """The port's stages on the first iteration's draws accept the pixels
    that the first ``trace_step`` accepts, and leave its threshold."""
    _, got, _ = _tracers()
    draws = pd.StreamDraws(got.cfg, _rank(got), "cpu")
    state, samples = pd.trace_step(got.cfg, got.data,
                                   pd.init_state(got.cfg, "cpu"), draws)
    mine = got.fit_predict_GP(np.zeros((0, 2), int),
                              draws=_IterationDraws(draws, 0))
    np.testing.assert_allclose(mine, samples.numpy(), rtol=1e-5, atol=1e-4)
    curves, costs, _ = got.get_best_curves(mine)
    fobs = got.get_best_pixels(curves, costs, np.zeros((0, 2), int))
    v = state.obs_valid.numpy()
    np.testing.assert_array_equal(
        fobs, np.stack([state.obs_x.numpy()[v], state.obs_y.numpy()[v]], 1))
    assert got.score_thresh == float(state.score_thresh)


def test_converged_fit_predict_matches_reference(monkeypatch):
    """``fit_predict_GP(converged=True)`` on a set of pixels, from the
    same restart draws, against the reference's batched final fit: the
    mean and the std at ``torch_parity.FINAL_FIT``'s bounds."""
    from torch_parity import FINAL_FIT
    ref, got, edge = _tracers()
    xs = np.arange(6, 90, 6)
    obs = np.stack([xs, edge[xs, 0]], axis=1)
    monkeypatch.setattr(rd, "optimize_lml",
                        functools.partial(rd.optimize_lml, use_batched=True))
    key = jax.random.PRNGKey(2)
    r_mean, r_std, *_ = rd._final_fit_buffers(
        ref.cfg, ref.data, key, *ref._buffers_for_obs(obs))
    g_mean, g_std = got.fit_predict_GP(obs, converged=True, draws=JaxKeyDraws(
        got.cfg, _rank(got), key))
    np.testing.assert_allclose(g_mean, np.asarray(r_mean),
                               rtol=FINAL_FIT["y_mean"][0],
                               atol=FINAL_FIT["y_mean"][1])
    np.testing.assert_allclose(g_std, np.asarray(r_std),
                               rtol=FINAL_FIT["y_std"][0],
                               atol=FINAL_FIT["y_std"][1])
    # The default stream of seed 2 is the port's own: a finite fit that
    # reaches the pixels.
    m, s = got.fit_predict_GP(obs, converged=True, seed=2)
    assert np.all(np.isfinite(m)) and np.all(s >= 0)
    assert np.abs(m[xs] - obs[:, 1]).max() < 2.0


# -- driver entry points -----------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The small config in both packages, the port's carried over from
    the reference's (``interop.from_reference``)."""
    _, edge, grad, init = small_problem()
    cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    return dict(cfg=cfg, data=data, state0=state0, pcfg=pcfg, pdata=pdata,
                pstate0=pstate0, rank=pdata.L_prior_unit.shape[1])


def test_preview_samples_matches_reference(small):
    """The initial posterior from the literal seed 0 (gpet.py:806), at the
    trajectory tolerance; the port's default stream is seed 0's
    whatever the config's seed."""
    ref = np.asarray(rd.preview_samples(small["cfg"], small["data"],
                                        small["state0"]))
    got = pd.preview_samples(small["pcfg"], small["pdata"], small["pstate0"],
                             draws=JaxKeyDraws(small["pcfg"], small["rank"],
                                               jax.random.PRNGKey(0)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=SAMPLES_RTOL,
                               atol=SAMPLES_ATOL)
    a = pd.preview_samples(small["pcfg"], small["pdata"], small["pstate0"])
    b = pd.preview_samples(small["pcfg"]._replace(seed=7), small["pdata"],
                           small["pstate0"])
    assert torch.equal(a, b)


def test_sample_round_and_final_fit_buffers_match_reference(small):
    """The public buffer functions on a padded training set (40 slots:
    the inits, 18 pixels within a pixel of the true edge, padding), from
    one key: the curves against the reference's at the trajectory
    tolerance; the final fit is ``_final_fit_buffers``' on the key's
    restarts, bit for bit (``test_converged_fit_predict_matches_reference``
    holds it to the reference's)."""
    cfg, pcfg = small["cfg"], small["pcfg"]
    _, edge, _, init = small_problem()
    rng = np.random.default_rng(5)
    cap = 40
    x = np.zeros(cap, np.int64)
    y = np.zeros(cap, np.int64)
    x[:2], y[:2] = init[:, 0], init[:, 1]
    x[2:20] = np.sort(rng.choice(np.arange(1, 95), 18, replace=False))
    y[2:20] = edge[x[2:20], 0] + rng.integers(-1, 2, 18)
    mask = np.arange(cap) < 20
    nw = np.ones(cap, np.float32)
    nw[:2] = cfg.init_noise_weight
    key = jax.random.PRNGKey(11)
    jargs = (jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32),
             jnp.asarray(mask), jnp.asarray(nw))
    targs = (torch.tensor(x), torch.tensor(y), torch.tensor(mask),
             torch.tensor(nw))
    draws = JaxKeyDraws(pcfg, small["rank"], key)
    ref = np.asarray(rd.sample_round_buffers(cfg, small["data"], *jargs, key))
    got = pd.sample_round_buffers(pcfg, small["pdata"], *targs, draws=draws)
    np.testing.assert_allclose(got.numpy(), ref, rtol=SAMPLES_RTOL,
                               atol=SAMPLES_ATOL)
    mean, std = pd.final_fit_buffers(pcfg, small["pdata"], *targs,
                                     draws=draws)
    whole = pd._final_fit_buffers(pcfg, small["pdata"], draws.restarts(),
                                  *targs)
    assert torch.equal(mean, whole[0]) and torch.equal(std, whole[1])
    # The default source is seed 0's own stream.
    assert torch.equal(
        pd.sample_round_buffers(pcfg, small["pdata"], *targs),
        pd.sample_round_buffers(pcfg, small["pdata"], *targs,
                                draws=pd.KeyDraws(pcfg, small["rank"],
                                                  "cpu", 0)))


def test_trace_step_matches_reference_and_run_trace(small):
    """``trace_step`` from the reference's draws gives the reference's
    step (pixels exact, the samples at the trajectory tolerance); stepped
    to the end and finished, it is ``run_trace`` bit for bit."""
    cfg, pcfg, pdata = small["cfg"], small["pcfg"], small["pdata"]
    draws = JaxDraws(pcfg, small["rank"])
    r_state, r_samples = rd.trace_step(cfg, small["data"], small["state0"])
    g_state, g_samples = pd.trace_step(pcfg, pdata, small["pstate0"], draws)
    np.testing.assert_allclose(g_samples.numpy(), np.asarray(r_samples),
                               rtol=SAMPLES_RTOL, atol=SAMPLES_ATOL)
    for f in ("obs_x", "obs_y", "obs_valid", "n_fobs", "iter_nobs"):
        np.testing.assert_array_equal(getattr(g_state, f).numpy(),
                                      np.asarray(getattr(r_state, f)), f)
    assert g_state.it == int(r_state.it) == 1
    state = small["pstate0"]
    while int(state.n_fobs) < pcfg.algo_thresh and state.it < pcfg.max_iters:
        state, _ = pd.trace_step(pcfg, pdata, state, draws)
    assert_same_bits(pd.finish_trace(pcfg, pdata, state, draws),
                     pd.run_trace(pcfg, pdata, small["pstate0"], draws))
    with pytest.raises(ValueError):
        pd.trace_step(pcfg, pdata, pd._lift(small["pstate0"]), draws)


# -- the introspective __call__ ----------------------------------------------

@pytest.mark.parametrize("option", ["return_lines", "verbose"])
def test_introspective_call_equals_fused(option, capsys):
    """``return_lines`` and ``verbose`` step the loop one ``trace_step``
    at a time: the result equals the fused call's bit for bit, with one
    read of the state before the loop and after each iteration and one of
    each iteration's curves."""
    _, got, _ = _tracers()
    fused = got()
    res_fused = got.last_result
    thresh = got.score_thresh
    for counts in (pd.HOST_READS, pd.HOST_BYTES):
        for k in counts:
            counts[k] = 0
    out = got(**{option: True})
    assert_same_bits(got.last_result, res_fused)
    n = res_fused.n_iters
    assert pd.HOST_READS["state"] == n + 1
    assert pd.HOST_READS["samples"] == n
    assert pd.HOST_BYTES["samples"] == 4 * n * got.edge_length * \
        got.N_samples
    assert got.score_thresh == thresh
    if option == "verbose":
        np.testing.assert_array_equal(out, fused)
        assert f"Iteration {n} - Time Elapsed" in capsys.readouterr().out
        return
    edge, (all_samples, all_obs, iter_curves) = out
    np.testing.assert_array_equal(edge, fused)
    assert len(all_samples) == n + 1 and len(all_obs) == n + 2
    assert len(iter_curves) == n + 1
    assert all_samples[0].shape == (got.edge_length, got.N_samples)
    np.testing.assert_array_equal(all_samples[-1],
                                  res_fused.y_mean.numpy())
    for i in range(n):
        np.testing.assert_array_equal(iter_curves[i][:, 1],
                                      res_fused.iter_curves[i].numpy())
        assert all_obs[i + 1].shape[0] == int(res_fused.iter_nobs[i])
    np.testing.assert_array_equal(iter_curves[-1], edge[:, [1, 0]])


def test_return_std_wins_over_return_lines():
    """As in the reference, ``return_std`` returns the interval whatever
    ``return_lines`` asks (models/tracer.py:112-120)."""
    _, got, _ = _tracers(return_std=True)
    edge, (lo, hi) = got(return_lines=True)
    assert lo.shape == hi.shape == (got.edge_length,)


def test_introspective_call_matches_reference():
    """The JAX package's ``return_lines`` path and the port's from the
    reference's draws: the same n_iters, iter_nobs and accepted pixels, and
    the observation lists entry by entry."""
    ref, got, _ = _tracers()
    got.draws = JaxDraws(got.cfg, _rank(got))
    r_edge, (_, r_obs, r_curves) = ref(return_lines=True)
    g_edge, (_, g_obs, g_curves) = got(return_lines=True)
    rr, gr = ref.last_result, got.last_result
    assert gr.n_iters == int(rr.n_iters)
    np.testing.assert_array_equal(gr.iter_nobs.numpy(),
                                  np.asarray(rr.iter_nobs))
    for f in ("obs_x", "obs_y", "obs_valid"):
        np.testing.assert_array_equal(getattr(gr, f).numpy(),
                                      np.asarray(getattr(rr, f)), f)
    assert len(g_obs) == len(r_obs)
    for a, b in zip(g_obs, r_obs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(g_curves[:-1], r_curves[:-1]):
        np.testing.assert_allclose(a, b, rtol=SAMPLES_RTOL,
                                   atol=SAMPLES_ATOL)
    assert got.score_thresh == ref.score_thresh


def test_introspective_options_refuse_an_ensemble():
    _, got, _ = _tracers()
    with pytest.raises(ValueError, match="introspective"):
        got(return_lines=True, ensemble=2)


@pytest.mark.parametrize("method", ["plot_iter", "plot_diagnostics"])
def test_plot_methods_name_the_missing_module(method, monkeypatch):
    """The tracer's plotting methods, once refused for want of
    ``utils/plotting.py``, now build their figure (Agg) from the
    introspective path's curves and costs, as the JAX tracer's do."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "show", lambda: None)
    _, got, _ = _tracers()
    _, (samples, obs, curves) = got(return_lines=True)
    if method == "plot_iter":
        fig = got.plot_iter(samples[0], 10, obs[0])
    else:
        res = got.last_result
        costs = list(res.iter_costs[:res.n_iters].numpy()) + [
            float(res.final_cost)]
        cred = res.cred_interval_px.numpy()
        fig = got.plot_diagnostics(curves, costs, (cred[0], cred[1]))
    assert isinstance(fig, matplotlib.figure.Figure) and fig.axes
    plt.close("all")


# -- the unbatched polish and the aliases ------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_unbatched_optimize_lml_matches_reference(seed):
    """``optimize_lml(use_batched=False)``: the LML through the library's
    Cholesky, ``screen_and_polish`` with ``torch.func`` derivatives, from
    the same starts as the JAX package's non-TPU path: the same optimum, θ
    within 1e-3. In float64, since in float32 the LML's rounding (~1e-6
    relative) lets both polishes stop ~2e-3 apart on its flat ridge."""
    rng = np.random.default_rng(seed)
    n = 24
    x = np.sort(rng.uniform(-1.7, 1.7, n))
    y = np.sin(2 * x) + rng.normal(0, 0.2, n)
    y = (y - y.mean()) / y.std()
    mask = np.ones(n, bool)
    mask[-4:] = False
    nw = np.ones(n)
    lb = np.log(np.array([0.01, 0.1, 1e-18]))
    ub = np.log(np.array([1e3, 100.0, 1.0]))
    starts = rng.random((13, 3)) * (ub - lb) + lb
    r_theta, r_lml = rd.optimize_lml(
        RefKernelSpec("RBF"), *map(jnp.asarray, (x, y, mask, nw, starts, lb,
                                                 ub)), use_batched=False)
    g_theta, g_lml = pd.optimize_lml(
        KernelSpec("RBF"), *map(torch.tensor, (x, y, mask, nw, starts, lb,
                                               ub)), use_batched=False)
    np.testing.assert_allclose(g_theta.numpy(), np.asarray(r_theta),
                               atol=1e-3)
    np.testing.assert_allclose(g_lml.numpy(), np.asarray(r_lml), rtol=1e-9)
    with pytest.raises(ValueError, match="one training set"):
        pd.optimize_lml(KernelSpec("RBF"), *map(torch.tensor, (
            x[None], y[None], mask[None], nw, starts, lb, ub)),
            use_batched=False)


def test_reference_module_aliases():
    """The reference layout: ``gpet``, ``gpet_utils`` and ``sklearn_gpr``
    expose the names the JAX package's aliases do."""
    from gaussian_process_edge_trace_torch import gpet, sklearn_gpr
    from gaussian_process_edge_trace_tpu import gpet as rgpet
    from gaussian_process_edge_trace_tpu import sklearn_gpr as rsk
    for mine, theirs in ((gpet, rgpet), (sklearn_gpr, rsk)):
        names = {n for n in vars(theirs) if not n.startswith("_")}
        assert names <= set(vars(mine)), names - set(vars(mine))
    assert gpet.GP_Edge_Tracing is gpt.GP_Edge_Tracing
    assert sklearn_gpr.GaussianProcessRegressor is \
        gpt.GaussianProcessRegressor
    for name in ("kernel_builder", "comp_grad_img", "normalise",
                 "construct_test_img", "trace_MSE", "trace_relarea",
                 "trace_dicecoef"):
        assert hasattr(gpt.gpet_utils, name) and hasattr(gpt, name), name
    with pytest.raises(AttributeError):
        gpt.not_a_name
