"""PyTorch port, the slice as a whole: the reference's ``run_trace`` and the
port's on identical data (carried across by ``interop.from_reference``) and
identical random draws (``torch_parity.JaxDraws``), then the final LML fit,
then the public ``GP_Edge_Tracing`` entry point."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch import interop
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.trace import kde as pkde
from gaussian_process_edge_trace_tpu.trace import driver as rd
from torch_parity import (BIG_KW, SMALL_KW, WIDE_IMG, WIDE_KW, JaxDraws,
                          big_problem, small_problem)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traced():
    """Both packages' traces of the small config from the same draws."""
    _, edge, grad, init = small_problem()
    cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    ref = jax.device_get(rd.run_trace(cfg, data, state0))
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    draws = JaxDraws(pcfg, pdata.L_prior_unit.shape[1])
    got = pd.run_trace(pcfg, pdata, pstate0, draws=draws)
    return dict(cfg=cfg, data=data, ref=ref, pcfg=pcfg, pdata=pdata,
                got=got, draws=draws, edge=edge, grad=grad, init=init)


def test_interop_carries_config_and_data(traced):
    ref_cfg, pcfg = traced["cfg"], traced["pcfg"]
    assert tuple(pcfg.kernel) == tuple(ref_cfg.kernel)
    assert tuple(pcfg.bins) == tuple(ref_cfg.bins)
    assert pcfg.n_train == ref_cfg.n_train and pcfg.M == ref_cfg.M
    for k in pd.TracerData._fields:
        np.testing.assert_array_equal(
            getattr(traced["pdata"], k).numpy(),
            np.asarray(getattr(traced["data"], k)), err_msg=k)


def test_interop_defaults_to_the_card(traced):
    """``from_reference`` builds its tensors on ``"cuda"`` unless asked for
    the CPU, like every other entry point of the port: without a card the
    default raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal")
    fields = traced["cfg"]._asdict()
    arrays = jax.device_get(traced["data"]._asdict())
    with pytest.raises((RuntimeError, AssertionError)):
        interop.from_reference(fields, arrays)
    _, data, state = interop.from_reference(fields, arrays, device="cpu")
    assert state is None and data.L_prior_unit.device.type == "cpu"


def test_port_data_matches_reference_data(traced):
    """The port's own make_data agrees with the reference's on the image:
    the prior factor bitwise, the rest to f32 rounding."""
    pdata = pd.make_data(traced["pcfg"], traced["grad"], traced["init"],
                         "cpu")
    for k in pd.TracerData._fields:
        np.testing.assert_allclose(
            getattr(pdata, k).numpy(), np.asarray(getattr(traced["data"], k)),
            rtol=2e-5, atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(pdata.L_prior_unit.numpy(),
                                  np.asarray(traced["data"].L_prior_unit))


def test_trajectory_matches_reference(traced):
    """Exact trajectory parity on the CPU: the same accepted pixels,
    iteration count and per-iteration observation counts. The optimal
    curve's cost per iteration agrees to 1e-5 relative (f32 sums in other
    orders)."""
    ref, got = traced["ref"], traced["got"]
    assert got.n_iters == int(ref.n_iters) >= 2
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.iter_costs.numpy(), ref.iter_costs,
                               rtol=1e-5)
    np.testing.assert_allclose(got.iter_thresh.numpy(), ref.iter_thresh,
                               rtol=1e-6)
    np.testing.assert_allclose(got.iter_curves.numpy(), ref.iter_curves,
                               rtol=1e-4, atol=1e-3)
    assert got.converged == bool(ref.converged)


def test_final_fit_matches_batched_reference(traced, monkeypatch):
    """The port's final fit against the reference's batched LML path
    (``optimize_lml(use_batched=True)``, the TPU path, forced here since the
    reference takes its unbatched path on the CPU), from the same training
    buffers and restart draws.

    Tolerances: θ = (log c, log ℓ) within 1e-3; log σn² within 5e-3,
    because the 4-step damped-Newton polish stops short of the optimum along
    that flat direction (the LML moves by ~3e-5 per 1e-2 of log σn² there)
    and f32 rounding moves where it stops; the LML within 1e-5 relative;
    the mean curve within 1e-2 px, and the integer trace equal wherever the
    mean is farther than that from a rounding boundary."""
    cfg, data = traced["cfg"], traced["data"]
    ref_res = traced["ref"]
    pad = cfg.n_train - cfg.n_inits - cfg.bins.n_bins
    x = np.concatenate([np.asarray(data.init_x), ref_res.obs_x,
                        np.zeros(pad, np.int32)])
    y = np.concatenate([np.asarray(data.init_y), ref_res.obs_y,
                        np.zeros(pad, np.int32)])
    mask = np.concatenate([np.ones(cfg.n_inits, bool), ref_res.obs_valid,
                           np.zeros(pad, bool)])
    nw = np.concatenate([np.full(cfg.n_inits, cfg.init_noise_weight,
                                 np.float32),
                         np.ones(cfg.n_train - cfg.n_inits, np.float32)])
    monkeypatch.setattr(rd, "optimize_lml",
                        functools.partial(rd.optimize_lml, use_batched=True))
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0)
    r_mean, r_std, _, r_theta, r_lml = (np.asarray(a) for a in
                                        rd._final_fit_buffers(
        cfg, data, key, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32),
        jnp.asarray(mask), jnp.asarray(nw)))
    p_mean, p_std, _, p_theta, p_lml = pd._final_fit_buffers(
        traced["pcfg"], traced["pdata"], traced["draws"].restarts(),
        torch.as_tensor(x, dtype=torch.int64),
        torch.as_tensor(y, dtype=torch.int64), torch.as_tensor(mask),
        torch.as_tensor(nw))
    np.testing.assert_allclose(p_theta[:2].numpy(), r_theta[:2], atol=1e-3)
    np.testing.assert_allclose(p_theta[2].numpy(), r_theta[2], atol=5e-3)
    np.testing.assert_allclose(p_lml.numpy(), r_lml, rtol=1e-5)
    dmean = np.abs(p_mean.numpy() - r_mean)
    assert dmean.max() < 1e-2
    np.testing.assert_allclose(p_std.numpy(), r_std, rtol=1e-2, atol=1e-3)
    far = np.abs(r_mean - np.floor(r_mean) - 0.5) > 1e-2
    np.testing.assert_array_equal(np.rint(p_mean.numpy())[far],
                                  np.rint(r_mean)[far])
    # The trace that run_trace returned comes from the same final fit.
    got = traced["got"]
    np.testing.assert_array_equal(got.edge_trace[:, 0].numpy(),
                                  np.rint(p_mean.numpy()))


def test_trajectory_matches_reference_at_large_sample_count(monkeypatch):
    """The branches of the 1000² S=10⁴ config on a narrow image: S = 8192
    (K1's transposed copy and the row take of the kept curves) and
    n_train = 176 > 160 (the coarse-to-fine final fit over the blocked
    Cholesky and solves). Given the reference's draws, the port accepts the
    same pixels in the same number of iterations.

    The reference's final fit runs its batched path, as on the TPU, with
    its Cholesky and triangular solves on XLA's LAPACK calls in place of
    the Pallas kernels, which interpret far too slowly at n = 176 (those
    kernels are held to the port's by ``test_torch_kernels.py``). The
    integer trace is identical in every column. The fit stops along a flat
    ridge of the LML (ROADMAP queue 3), where f32 rounding in another order
    moves log c by 0.12 here at an LML 3e-4 relative apart: θ is held to
    0.15 in log c and 0.03 in log ℓ and log σn², the LML to 1e-3 relative
    and the mean curve to 2e-2 px."""
    from jax.scipy.linalg import solve_triangular

    from gaussian_process_edge_trace_tpu.ops import pallas_chol as pc
    monkeypatch.setattr(rd, "optimize_lml",
                        functools.partial(rd.optimize_lml, use_batched=True))
    monkeypatch.setattr(pc, "cholesky_auto", jnp.linalg.cholesky)
    monkeypatch.setattr(pc, "forward_solve_auto",
                        lambda L, R: solve_triangular(L, R, lower=True))
    monkeypatch.setattr(pc, "backward_solve_auto",
                        lambda L, R: solve_triangular(L, R, lower=True,
                                                      trans="T"))
    _, edge, grad, init = small_problem(WIDE_IMG)
    cfg = rd.make_config(init, grad.shape, **WIDE_KW)
    assert cfg.N_samples >= 8192 and cfg.n_train > 160
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    ref = jax.device_get(rd.run_trace(cfg, data, state0))
    pcfg, pdata, pstate0 = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    got = pd.run_trace(pcfg, pdata, pstate0,
                       draws=JaxDraws(pcfg, pdata.L_prior_unit.shape[1]))
    assert got.n_iters == int(ref.n_iters) >= 2
    for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(got.iter_costs.numpy(), ref.iter_costs,
                               rtol=1e-5)
    np.testing.assert_allclose(got.lml.numpy(), ref.lml, rtol=1e-3)
    assert np.all(np.abs(got.theta.numpy() - ref.theta)
                  <= [0.15, 0.03, 0.03]), (got.theta, ref.theta)
    assert np.abs(got.y_mean.numpy() - np.asarray(ref.y_mean)).max() < 2e-2
    np.testing.assert_array_equal(got.edge_trace.numpy(),
                                  np.asarray(ref.edge_trace))
    assert gpt.trace_dicecoef(got.edge_trace.numpy(), edge) > 0.97


def test_first_iterations_match_reference_at_1000():
    """The 1000² S=10⁴ config itself (``benchmarks/suite.py`` config 4,
    uncut), for its first three iterations. The port's gradient image agrees
    with the reference's, and its ``make_data`` on the same gradient image
    with the reference's: the rank-48 prior
    factor bitwise, the gradient KDE (shifted-multiply-add blur on both
    axes of the 1002² grid) to f32 rounding. Then, from the reference's
    draws, each iteration accepts the same pixels with the same threshold,
    through K1's transposed copy, the row take of 1000 kept curves and the
    curve KDE blurred the same way. The whole trace with its final fit is
    compared by ``tests/torch_reference_1000.py`` (minutes per seed)."""
    img, _, grad, init = big_problem()
    np.testing.assert_allclose(
        gpt.comp_grad_img(img, gpt.kernel_builder((11, 5)),
                          device="cpu").numpy(), grad, rtol=2e-5, atol=2e-6)
    cfg = rd.make_config(init, grad.shape, **BIG_KW)
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    assert data.L_prior_unit.shape == (1000, 48) and cfg.n_train == 208
    own = pd.make_data(pd.make_config(init, grad.shape, **BIG_KW), grad,
                       init, "cpu")
    for k in pd.TracerData._fields:
        np.testing.assert_allclose(
            getattr(own, k).numpy(), np.asarray(getattr(data, k)),
            rtol=2e-5, atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(own.L_prior_unit.numpy(),
                                  np.asarray(data.L_prior_unit))
    assert pkde.blur_matrices(cfg.M, cfg.N) is None     # FMA on both axes

    state = rd.init_state(cfg)
    pcfg, pdata, pstate = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state._asdict()), device="cpu")
    draws = JaxDraws(pcfg, pdata.L_prior_unit.shape[1])
    inv = pd.loop_invariants(pcfg, pdata)
    for it in range(3):
        state, _ = rd.trace_step(cfg, data, state)
        pstate, _ = pd.trace_step(pcfg, pdata, pstate, draws, inv)
        ref = jax.device_get(state)
        for f in ("obs_x", "obs_y", "obs_valid", "n_fobs", "score_thresh"):
            np.testing.assert_array_equal(
                getattr(pstate, f).numpy(), np.asarray(getattr(ref, f)),
                err_msg=f"iteration {it}: {f}")
        np.testing.assert_allclose(pstate.iter_costs[it].item(),
                                   ref.iter_costs[it], rtol=1e-5)
    assert int(ref.n_fobs) > 0


def test_gp_edge_tracing_replays_reference_draws(traced):
    """The public entry point with the reference's draws gives the trace
    that run_trace gave."""
    tracer = gpt.GP_Edge_Tracing(
        traced["init"], traced["grad"], SMALL_KW["kernel_options"], 1,
        np.array([]), 256, 1, 6, 0.1, 4, 1, True, True, device="cpu",
        draws=traced["draws"])
    edge, (lo, hi) = tracer()
    np.testing.assert_array_equal(edge, traced["got"].edge_trace.numpy())
    assert edge.shape == (96, 2) and lo.shape == hi.shape == (96,)
    assert np.all(lo <= hi)


def test_gp_edge_tracing_default_draws_on_cpu():
    """The default torch draws trace the small image as well as the
    reference does (its DICE here is 0.99)."""
    _, edge, grad, init = small_problem()
    tracer = gpt.GP_Edge_Tracing(init, grad, SMALL_KW["kernel_options"], 1,
                                 np.array([]), 256, 1, 6, 0.1, 4, 1, False,
                                 True, device="cpu")
    out = tracer()
    assert out.shape == (96, 2)
    np.testing.assert_array_equal(out[:, 1], np.arange(96))
    assert gpt.trace_dicecoef(out, edge) > 0.97
    again = gpt.GP_Edge_Tracing(init, grad, SMALL_KW["kernel_options"], 1,
                                np.array([]), 256, 1, 6, 0.1, 4, 1, False,
                                True, device="cpu")()
    np.testing.assert_array_equal(out, again)      # seeded: reproducible


@pytest.mark.parametrize("option", ["print_final_diagnostics",
                                    "show_init_post", "show_post_iter"])
def test_unported_call_options_raise(option, monkeypatch):
    """The plotting options, once refused here, now draw (matplotlib,
    Agg; ``utils/plotting.py``) and raise nothing: the trace they return
    is the plain call's, bit for bit; ``show_init_post`` goes on after a
    "y" and draws one more fan chart than it would without."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from gaussian_process_edge_trace_torch.utils import plotting
    monkeypatch.setattr(plt, "show", lambda: None)
    monkeypatch.setattr("builtins.input", lambda: "y")
    drawn = []
    for name in ("plot_iter", "plot_diagnostics"):
        fn = getattr(plotting, name)
        monkeypatch.setattr(plotting, name, lambda *a, _f=fn, _n=name, **k:
                            drawn.append(_n) or _f(*a, **k))
    _, _, grad, init = small_problem()
    tracer = gpt.GP_Edge_Tracing(init, grad, device="cpu")
    plain = tracer()
    out = tracer(**{option: True})
    np.testing.assert_array_equal(out, plain)
    n = tracer.last_result.n_iters
    want = {"print_final_diagnostics": ["plot_diagnostics"],
            "show_init_post": ["plot_iter"],
            "show_post_iter": ["plot_iter"] * n}[option]
    assert drawn == want
    plt.close("all")


def test_gp_edge_tracing_ensemble():
    """``ensemble=3`` keeps the member of ``trace_ensemble`` with the
    lowest final cost, whose result ``last_result`` holds; member 0 is the
    plain call's trace, and ``ensemble=1`` is the plain call."""
    from gaussian_process_edge_trace_torch.parallel import trace_ensemble
    _, edge, grad, init = small_problem()
    args = (init, grad, SMALL_KW["kernel_options"], 1, np.array([]), 256, 1,
            6, 0.1, 4, 1, False, True)
    tracer = gpt.GP_Edge_Tracing(*args, device="cpu")
    out = tracer(ensemble=3)
    best, every = trace_ensemble(tracer.cfg, tracer.data,
                                 pd.init_state(tracer.cfg, "cpu"), n_seeds=3,
                                 return_all=True)
    np.testing.assert_array_equal(out, best.edge_trace.numpy())
    assert float(tracer.last_result.final_cost) == float(
        every.final_cost.min())
    single = gpt.GP_Edge_Tracing(*args, device="cpu")()
    np.testing.assert_array_equal(every.edge_trace[0].numpy(), single)
    np.testing.assert_array_equal(tracer(ensemble=1), single)
    assert gpt.trace_dicecoef(out, edge) > 0.97


def test_gp_edge_tracing_ensemble_below_one_raises():
    _, _, grad, init = small_problem()
    tracer = gpt.GP_Edge_Tracing(init, grad, device="cpu")
    with pytest.raises(ValueError, match="ensemble"):
        tracer(ensemble=0)


def test_warm_start_observations_are_used_once():
    """User observations join the first fit only, then give way to the
    binned selection (gpet.py:820,857)."""
    _, edge, grad, init = small_problem()
    obs = np.array([[30, edge[30, 0]], [60, edge[60, 0]]])
    cfg = pd.make_config(init, grad.shape, n_user_obs=2, **SMALL_KW)
    data = pd.make_data(cfg, grad, init, "cpu")
    state = pd.init_state(cfg, "cpu", user_obs_xy=obs)
    assert int(state.n_fobs) == 2 and bool(state.user_valid.all())
    with pytest.raises(ValueError):
        pd.init_state(cfg, "cpu", user_obs_xy=obs[:1])
    after = pd.run_loop(cfg, data, state)
    assert after.it >= 1 and not bool(after.user_valid.any())
