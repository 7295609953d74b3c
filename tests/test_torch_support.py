"""PyTorch port, support modules: kernels, image utilities, metrics, config,
the prior factor, Simpson rules, the KDEs, pixel selection and Matheron
sampling — each against its JAX counterpart on the same float32 inputs."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_edge_trace_torch.models import gpr as pgpr
from gaussian_process_edge_trace_torch.models import kernels as pk
from gaussian_process_edge_trace_torch.models.newton import lml_screen_grid
from gaussian_process_edge_trace_torch.ops import integrate as pint
from gaussian_process_edge_trace_torch.trace import driver as pd
from gaussian_process_edge_trace_torch.trace import kde as pkde
from gaussian_process_edge_trace_torch.trace import select as psel
from gaussian_process_edge_trace_torch.trace.scoring import best_curves
from gaussian_process_edge_trace_torch.utils import image as pimg
from gaussian_process_edge_trace_torch.utils import metrics as pmet
from gaussian_process_edge_trace_torch.utils import synthetic as psyn
from gaussian_process_edge_trace_tpu.models import gpr as rgpr
from gaussian_process_edge_trace_tpu.models import kernels as rk
from gaussian_process_edge_trace_tpu.models import newton as rnewton
from gaussian_process_edge_trace_tpu.ops import integrate as rint
from gaussian_process_edge_trace_tpu.trace import driver as rd
from gaussian_process_edge_trace_tpu.trace import kde as rkde
from gaussian_process_edge_trace_tpu.trace.pallas_kde import (
    column_binning as ref_column_binning)
from gaussian_process_edge_trace_tpu.trace import select as rsel
from gaussian_process_edge_trace_tpu.utils import image as rimg
from gaussian_process_edge_trace_tpu.utils import metrics as rmet
from gaussian_process_edge_trace_tpu.utils import synthetic as rsyn
from torch_parity import SMALL_KW, j32, small_problem, t32

torch.set_num_threads(1)

KERNELS = [("RBF", 2.5), ("Matern", 1.5), ("Matern", 2.5)]


# --- models/kernels.py -------------------------------------------------------

@pytest.mark.parametrize("kind,nu", KERNELS)
def test_kernel_functions_match(kind, nu):
    d = np.linspace(0, 6, 97).astype(np.float32)
    rs, ps = rk.KernelSpec(kind, nu), pk.KernelSpec(kind, nu)
    for rf, pf in ((rk.k_unit, pk.k_unit),
                   (rk.dk_unit_dlog_ls, pk.dk_unit_dlog_ls)):
        np.testing.assert_allclose(pf(ps, t32(d)).numpy(),
                                   np.asarray(rf(rs, j32(d))),
                                   rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(pk.k_unit_np(ps, d.astype(np.float64)),
                                  rk.k_unit_np(rs, d.astype(np.float64)))


@pytest.mark.parametrize("kind,nu", KERNELS)
def test_train_gram_mask_and_padding(kind, nu):
    """Masked rows/columns zeroed, identity on the padded diagonal."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 50, 12).astype(np.float32)
    noise = rng.uniform(0.1, 1, 12).astype(np.float32)
    mask = np.arange(12) < 9
    ref = np.asarray(rk.train_gram(rk.KernelSpec(kind, nu), j32(x), 7.0,
                                   3.0, j32(noise), mask=jnp.asarray(mask)))
    got = pk.train_gram(pk.KernelSpec(kind, nu), t32(x), 7.0, 3.0,
                        t32(noise), mask=torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(got[9:, 9:], np.eye(3))
    assert not got[:9, 9:].any()


@pytest.mark.parametrize("opts", [
    {"kernel": "RBF", "sigma_f": 75, "length_scale": 20},
    {"kernel": "Matern", "sigma_f": 30, "length_scale": 9, "nu": 1.5},
    (1, 3, 3), (0, 4, 4), (2, 1, 0), (1, 9, 7)])
def test_resolve_kernel_options_matches(opts):
    ref = rk.resolve_kernel_options(opts, 500, 480)
    got = pk.resolve_kernel_options(opts, 500, 480)
    assert tuple(got[0]) == tuple(ref[0]) and got[1:] == ref[1:]


# --- utils -------------------------------------------------------------------

@pytest.mark.parametrize("ltype", ["sinusoidal", "multi-sinusoidal",
                                   "diag", "straight"])
def test_synthetic_image_equal(ltype):
    a = psyn.construct_test_img((60, 80), 30, 2, 0.05, ltype, 0.3, gaps=True)
    b = rsyn.construct_test_img((60, 80), 30, 2, 0.05, ltype, 0.3, gaps=True)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("size,unit", [((11, 5), False), ((9, 5), True),
                                       ((7, 3), False)])
def test_image_preprocessing_matches(size, unit):
    img, _ = rsyn.construct_test_img((60, 80), 30, 2, 0.05, "sinusoidal",
                                     0.3, gaps=True)
    k = pimg.kernel_builder(size, unit=unit)
    np.testing.assert_array_equal(k, rimg.kernel_builder(size, unit=unit))
    np.testing.assert_allclose(pimg.normalise(img * 3 + 1).numpy(),
                               np.asarray(rimg.normalise(img * 3 + 1)),
                               rtol=1e-6, atol=1e-7)
    got = pimg.comp_grad_img(img, k).numpy()
    ref = np.asarray(rimg.comp_grad_img(img, k))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_metrics_match_including_negative_wrap():
    """MSE and DICE, including the reference's wrap of negative y starts."""
    rng = np.random.default_rng(2)
    true = np.stack([rng.integers(0, 60, 80), np.arange(80)], axis=1)
    for pred_y in (true[:, 0] + rng.integers(-3, 4, 80),
                   np.where(np.arange(80) % 9 == 0, -7, true[:, 0]),
                   np.full(80, -200)):
        pred = np.stack([pred_y, np.arange(80)], axis=1)
        assert pmet.trace_MSE(pred, true) == pytest.approx(
            float(rmet.trace_MSE(pred, true)), abs=1e-4)
        for jac in (False, True):
            assert pmet.trace_dicecoef(pred, true, jac) == pytest.approx(
                float(rmet.trace_dicecoef(pred, true, jac)), abs=1e-4)


# --- config, bins and the prior factor ---------------------------------------

@pytest.mark.parametrize("kw", [
    dict(SMALL_KW),
    dict(SMALL_KW, N_samples=80, delta_x=3, keep_ratio=1.5, pixel_thresh=1,
         score_thresh=2.0, fix_endpoints=False),
    dict(SMALL_KW, kernel_options=(1, 3, 3), n_user_obs=3, delta_x=7),
])
def test_make_config_matches_with_clamps(kw):
    """Every field, including the clamps of gpet.py:95-119 and N_keep from
    the raw arguments (N_samples=80 clamps to 1000 but N_keep stays 12)."""
    init = np.array([[95, 30], [3, 20]])
    ref = rd.make_config(init, (64, 100), **kw)
    got = pd.make_config(init, (64, 100), **kw)
    r, g = ref._asdict(), got._asdict()
    assert tuple(g.pop("kernel")) == tuple(r.pop("kernel"))
    assert tuple(g.pop("bins")) == tuple(r.pop("bins"))
    assert g == r


def test_make_config_demo_clamps():
    init = np.array([[0, 250], [499, 250]])
    cfg = pd.make_config(init, (500, 500), kernel_options={
        "kernel": "RBF", "sigma_f": 75, "length_scale": 20}, N_samples=1000,
        delta_x=5, keep_ratio=0.1, pixel_thresh=5)
    assert (cfg.N_keep, cfg.N_subints, cfg.algo_thresh) == (100, 100, 96)
    assert cfg.bins.n_bins == 101 and cfg.n_train == 104


@pytest.mark.parametrize("N,x_st,x_en,dx", [(96, 0, 95, 6), (100, 7, 93, 5),
                                            (61, 10, 50, 4)])
def test_bin_spec_rounds_half_to_even(N, x_st, x_en, dx):
    assert tuple(psel.make_bin_spec(N, x_st, x_en, dx)) == tuple(
        rsel.make_bin_spec(N, x_st, x_en, dx))
    spec = psel.make_bin_spec(N, x_st, x_en, dx)
    np.testing.assert_array_equal(
        psel.bin_of_col(spec, N), np.asarray(rsel._bin_of_col(
            rsel.BinSpec(*spec), N)))


@pytest.mark.parametrize("max_decays", [1, 7, 400, 1000])
def test_decay_ladder_bitwise(max_decays):
    """The threshold ladder equals the reference's jnp.cumprod bit for
    bit (a sequential product differs from it in most entries)."""
    d = jnp.concatenate([jnp.ones((1,), jnp.float32),
                         jnp.full((max_decays - 1,), 0.95, jnp.float32)])
    ref = np.asarray(jnp.cumprod(d))
    np.testing.assert_array_equal(psel.decay_ladder(max_decays), ref)


@pytest.mark.parametrize("kind,nu,ls", [("RBF", 2.5, 20.0),
                                        ("Matern", 2.5, 8.0),
                                        ("Matern", 1.5, 30.0)])
def test_prior_factor_truncation(kind, nu, ls):
    """The (N, r) factor: r a multiple of 8 and ≤ N, the dropped variance
    per column ≤ the threshold, and equal to the reference's factor."""
    init = np.array([[0, 10], [119, 10]])
    ko = {"kernel": kind, "sigma_f": 10, "length_scale": ls, "nu": nu}
    cfg = pd.make_config(init, (40, 120), kernel_options=ko)
    F = pd.prior_factor(cfg).astype(np.float64)
    N, r = F.shape
    assert N == 120 and r % 8 == 0 and r <= N
    cols = np.arange(N, dtype=np.float64)
    K = pk.k_unit_np(cfg.kernel, np.abs(cols[:, None] - cols) / cfg.sigma_l)
    K[np.diag_indices(N)] += cfg.gp_jitter
    w_max = np.linalg.eigvalsh(K)[-1]
    thr = max(2 * cfg.gp_jitter, w_max * 1e-8)
    assert np.max(np.diag(K - F @ F.T)) <= thr
    rd.prior_factor.cache_clear()
    ref_cfg = rd.make_config(init, (40, 120), kernel_options=ko)
    np.testing.assert_array_equal(pd.prior_factor(cfg),
                                  np.asarray(rd.prior_factor(ref_cfg)[0]))


def test_prior_factor_full_rank_flag_is_part_of_cache_key(monkeypatch):
    init = np.array([[0, 10], [79, 10]])
    cfg = pd.make_config(init, (40, 80), kernel_options={
        "kernel": "RBF", "sigma_f": 10, "length_scale": 9})
    monkeypatch.delenv("GPET_FULL_RANK_PRIOR", raising=False)
    r_trunc = pd.prior_factor(cfg).shape[1]
    monkeypatch.setenv("GPET_FULL_RANK_PRIOR", "1")
    assert pd.prior_factor(cfg).shape[1] == 80 > r_trunc
    monkeypatch.delenv("GPET_FULL_RANK_PRIOR")
    assert pd.prior_factor(cfg).shape[1] == r_trunc


# --- ops/integrate.py --------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 8, 9])
@pytest.mark.parametrize("even", ["simpson", "avg"])
def test_simpson_matches(n, even):
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.uniform(0.5, 2, n)).astype(np.float32)
    y = rng.normal(size=(4, n)).astype(np.float32)
    ref = np.asarray(rint.simpson_nonuniform(j32(y), j32(x), even=even))
    got = pint.simpson_nonuniform(t32(y), t32(x), even=even).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    h = np.diff(x)
    got_h = pint.simpson_nonuniform(t32(y.T), h=t32(h), axis=0,
                                    even=even).numpy()
    np.testing.assert_allclose(got_h, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        pint.simpson_weights(t32(x), even=even).numpy(),
        np.asarray(rint.simpson_weights(j32(x), even=even)),
        rtol=1e-6, atol=1e-7)


# --- KDEs --------------------------------------------------------------------

def test_frame_arrays_match():
    """Normalised gradient image, gradient KDE, columns and sorted init."""
    _, _, grad, init = small_problem()
    ref_cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    cfg = pd.make_config(init, grad.shape, **SMALL_KW)
    ref = [np.asarray(a) for a in rd.frame_arrays(
        ref_cfg, j32(grad), jnp.asarray(init[::-1]))]
    got = [a.numpy() for a in pd.frame_arrays(cfg, grad, init[::-1], "cpu")]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("M,N,x0,E", [(64, 96, 0, 96), (40, 70, 5, 51)])
def test_curve_kde_matches(M, N, x0, E):
    """Binning with the out-of-image rule, blur and min-max."""
    rng = np.random.default_rng(M)
    y = (M / 2 + np.cumsum(rng.normal(0, 2, (E, 25)), axis=0))
    y[:, 0] = -4.5                       # whole curve out of the image
    y = y.astype(np.float32)
    wts = rng.uniform(0.5, 1.5, 25).astype(np.float32)
    wts /= wts.sum()
    ref = np.asarray(rkde.curve_kde(j32(y), j32(wts), M, N, x0))
    got = pkde.curve_kde(t32(y), t32(wts), M, N, x0,
                         blur=pkde.blur_matrices(M, N)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        pkde.column_binning(t32(y), t32(wts), M).numpy(),
        np.asarray(ref_column_binning(j32(y), j32(wts), M)),
        rtol=1e-5, atol=1e-7)


def test_blur_forms_agree():
    """The Toeplitz-matmul and shifted multiply-add blurs are one
    function."""
    g = torch.rand(30, 40)
    taps = pkde.gaussian_taps(8)
    mat = pkde._separable_blur(g, taps)
    fma = pkde._blur_axis_fma(pkde._blur_axis_fma(g, taps, 0), taps, 1)
    torch.testing.assert_close(mat, fma, rtol=1e-5, atol=1e-6)


# --- selection ---------------------------------------------------------------

@pytest.mark.parametrize("fix_endpoints", [True, False])
@pytest.mark.parametrize("thresh,n_pre", [(1.0, 0), (0.6, 5)])
def test_select_pixels_matches(fix_endpoints, thresh, n_pre):
    rng = np.random.default_rng(int(thresh * 10) + n_pre)
    M, N = 40, 61
    spec = psel.make_bin_spec(N, 3, 57, 5)
    kde = rng.random((M, N)).astype(np.float32) ** 3
    kde[:, 20:24] = 0.0                       # empty columns
    gk = rng.random((M, N)).astype(np.float32)
    K = spec.n_bins + 2
    ox = rng.integers(0, N, K)
    oy = rng.integers(0, M, K)
    ov = rng.random(K) < 0.5
    args = dict(spec=spec, fix_endpoints=fix_endpoints, kde_thresh=1e-3,
                pixel_thresh=5, algo_thresh=spec.n_bins - 4, max_decays=400)
    ref = rsel.select_pixels(
        j32(kde), j32(gk), jnp.asarray(ox, jnp.int32),
        jnp.asarray(oy, jnp.int32), jnp.asarray(ov), n_pre=n_pre,
        score_thresh=jnp.float32(thresh), **dict(args, spec=rsel.BinSpec(
            *spec)))
    got = psel.select_pixels(
        t32(kde), t32(gk), torch.as_tensor(ox), torch.as_tensor(oy),
        torch.as_tensor(ov), n_pre=n_pre,
        score_thresh=torch.tensor(thresh, dtype=torch.float32), **args)
    for f in ("obs_x", "obs_y", "obs_valid", "n_fobs", "score_thresh"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_best_curves_tie_order():
    """Equal costs keep lax.top_k's order: the lower index first."""
    costs = torch.tensor([3.0, 1.0, 2.0, 1.0, 1.0, 0.5, 2.0])
    y = torch.arange(7.0)[None, :].repeat(4, 1)
    best, bc = best_curves(y, costs, 5)
    _, idx = jax.lax.top_k(-jnp.asarray(costs.numpy()), 5)
    np.testing.assert_array_equal(best[0].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(bc.numpy(), [0.5, 1.0, 1.0, 1.0, 2.0])


# --- GP regression -----------------------------------------------------------

def _gp_problem(n=24, n_valid=19, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.choice(96, n, replace=False))
    y = (30 + 8 * np.sin(x / 9) + rng.normal(0, 1, n)).astype(np.int64)
    mask = np.arange(n) < n_valid
    noise_w = np.ones(n, np.float32)
    noise_w[:2] = 1e-7
    return x, y, mask, noise_w


def test_fit_and_sample_matches_with_injected_normals():
    """Matheron draws from the same normals: the reference's own keys."""
    _, _, grad, init = small_problem()
    ref_cfg = rd.make_config(init, grad.shape, **SMALL_KW)
    F = np.asarray(rd.prior_factor(ref_cfg)[0])
    x, y, mask, nw = _gp_problem()
    key = jax.random.PRNGKey(3)
    k_prior, k_noise = jax.random.split(key)
    S = 64
    z = jax.random.normal(k_prior, (F.shape[1], S), jnp.float32)
    w = jax.random.normal(k_noise, (x.shape[0], S), jnp.float32)
    grid = np.arange(96)
    diag = (1.0 * nw + 1e-6).astype(np.float32)
    spec = rk.KernelSpec("RBF")
    ref = np.asarray(rgpr.fit_and_sample(
        key, spec, jnp.asarray(x, jnp.float32), j32(y / 9.0), 8.0,
        jnp.float32(4.0), j32(diag), jnp.asarray(mask), j32(F),
        x_idx=jnp.asarray(x, jnp.int32), grid_out=jnp.asarray(grid,
                                                              jnp.int32),
        n_samples=S, post_scale=jnp.float32(0.8)))
    got = pgpr.fit_and_sample(
        pk.KernelSpec("RBF"), t32(x), t32(y / 9.0), 8.0,
        torch.tensor(4.0), t32(diag), torch.as_tensor(mask), t32(F),
        x_idx=torch.as_tensor(x), grid_out=torch.as_tensor(grid), z=t32(z),
        w=t32(w), post_scale=torch.tensor(0.8)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_gp_fit_predict_match():
    x, y, mask, nw = _gp_problem(seed=1)
    xs = ((x - 48) / 28).astype(np.float32)
    ys = ((y - 30) / 6).astype(np.float32)
    diag = (0.05 * nw + 1e-6).astype(np.float32)
    xq = np.linspace(-2, 2, 50).astype(np.float32)
    for kind, nu in KERNELS:
        rs = rgpr.gp_fit(rk.KernelSpec(kind, nu), j32(xs), j32(ys), 0.4, 1.5,
                         j32(diag), jnp.asarray(mask))
        ps = pgpr.gp_fit(pk.KernelSpec(kind, nu), t32(xs), t32(ys), 0.4, 1.5,
                         t32(diag), torch.as_tensor(mask))
        rm, rsd = rgpr.gp_predict(rk.KernelSpec(kind, nu), rs, j32(xq), 0.4,
                                  1.5, return_std=True)
        pm, psd = pgpr.gp_predict(pk.KernelSpec(kind, nu), ps, t32(xq), 0.4,
                                  torch.tensor(1.5), return_std=True)
        np.testing.assert_allclose(pm.numpy(), np.asarray(rm), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(psd.numpy(), np.asarray(rsd), rtol=1e-3,
                                   atol=1e-4)


def test_safe_cholesky_takes_first_factor_that_succeeds():
    K = torch.tensor([[1.0, 1.0], [1.0, 1.0 - 1e-7]])   # not PD in f32
    L = pgpr.safe_cholesky(K, jitter_scales=(0.0, 1e-3))
    torch.testing.assert_close(L @ L.T, K + 1e-3 * K.diagonal().mean()
                               * torch.eye(2), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind,nu", KERNELS)
def test_batched_lml_values_and_gradients_match(kind, nu):
    """Values and analytic gradients at well-conditioned θ."""
    x, y, mask, nw = _gp_problem(seed=2)
    xs = np.where(mask, (x - x[mask].mean()) / x[mask].std(), 0)
    ys = np.where(mask, (y - y[mask].mean()) / y[mask].std(), 0)
    th = np.array([[0.0, -1.0, -2.0], [1.0, -0.5, -3.0], [0.5, 0.0, -1.0],
                   [-1.0, -1.5, -4.0]], np.float32)
    rv, rg = rgpr.batched_lml(rk.KernelSpec(kind, nu), j32(xs), j32(ys),
                              jnp.asarray(mask), j32(th), j32(nw),
                              with_grad=True)
    pv, pg = pgpr.batched_lml(pk.KernelSpec(kind, nu), t32(xs), t32(ys),
                              torch.as_tensor(mask), t32(th), t32(nw),
                              with_grad=True)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-4)
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=2e-3,
                               atol=2e-3)


def test_log_marginal_likelihood_matches():
    """One θ, against the reference without its PD probe, to 1e-4
    relative as in the batched test: f32 Cholesky factors in other orders
    move the quadratic term by ~2e-5 relative at the first θ. A non-PD Gram
    (negative noise weights pull the smooth RBF Gram below zero) gives
    NaN."""
    x, y, mask, nw = _gp_problem(seed=4)
    xs = np.where(mask, (x - x[mask].mean()) / x[mask].std(), 0)
    ys = np.where(mask, (y - y[mask].mean()) / y[mask].std(), 0)
    for th in ([0.3, -0.8, -2.5], [1.2, 0.1, -0.7]):
        ref = rgpr.log_marginal_likelihood(
            rk.KernelSpec("RBF"), j32(xs), j32(ys), jnp.asarray(mask),
            j32(th), j32(nw), pd_guard=False)
        got = pgpr.log_marginal_likelihood(
            pk.KernelSpec("RBF"), t32(xs), t32(ys), torch.as_tensor(mask),
            t32(th), t32(nw))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)
    bad = pgpr.batched_lml(pk.KernelSpec("RBF"), t32(xs), t32(ys),
                           torch.as_tensor(mask), t32([[0.0, -1.0, -2.0]]),
                           -t32(nw))
    assert torch.isnan(bad).all()


def test_optimize_lml_coarse_to_fine_branch():
    """Above 160 training points the fit screens and polishes on a
    stride-subsampled set, then re-polishes at full size from the coarse
    optimum and the default start (driver.py:534-552). The polish is
    monotone, so the result is a θ inside the box whose full-size LML is the
    returned value and no worse than the default start's. (On this problem
    the branch lands ~60 LML units below a direct full-size screen, in the
    reference too: ROADMAP queue 3.)"""
    rng = np.random.default_rng(5)
    n = 176
    x = np.sort(rng.choice(1000, n, replace=False)).astype(np.float32)
    y = (300 + 40 * np.sin(x / 60) + rng.normal(0, 2, n)).astype(np.float32)
    mask = torch.ones(n, dtype=torch.bool)
    nw = torch.ones(n)
    nw[:2] = 1e-7
    xs = torch.tensor((x - x.mean()) / x.std())
    ys = torch.tensor((y - y.mean()) / y.std())
    lb = torch.log(torch.tensor([0.01, 0.1, 1e-18]))
    ub = torch.log(torch.tensor([1e3, 100.0, 1.0]))
    starts = torch.cat([torch.log(torch.tensor([[5.0, 5.0, 1.0]])),
                        torch.rand(12, 3, generator=torch.Generator()
                                   .manual_seed(0)) * (ub - lb) + lb])
    spec = pk.KernelSpec("RBF")
    theta, lml = pd.optimize_lml(spec, xs, ys, mask, nw, starts, lb, ub)
    assert bool(((theta >= lb) & (theta <= ub)).all())
    at = pgpr.batched_lml(spec, xs, ys, mask, torch.stack([theta,
                                                           starts[0]]), nw)
    np.testing.assert_allclose(lml.item(), at[0].item(), rtol=1e-6)
    assert lml.item() >= at[1].item()


def test_torch_draws_are_seeded_per_iteration():
    cfg = pd.make_config(np.array([[0, 10], [95, 10]]), (40, 96),
                         **dict(SMALL_KW, seed=7))
    d = pd.TorchDraws(cfg, 32, "cpu")
    z0, w0 = d.normals(0)
    assert z0.shape == (32, 256) and w0.shape == (cfg.n_train, 256)
    torch.testing.assert_close(d.normals(0)[0], z0, rtol=0, atol=0)
    assert not torch.equal(d.normals(1)[0], z0)
    u = d.restarts()
    assert u.shape == (12, 3) and bool((u >= 0).all() and (u < 1).all())


def test_lml_screen_grid_matches():
    lb = np.log(np.array([0.01, 0.1, 1e-18], np.float32))
    ub = np.log(np.array([1e3, 100.0, 1.0], np.float32))
    ref = np.asarray(rnewton.lml_screen_grid(j32(lb), j32(ub), jnp.float32))
    got = lml_screen_grid(torch.tensor(lb), torch.tensor(ub)).numpy()
    assert got.shape == (96, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_port_never_imports_jax():
    """Importing every module of the port leaves JAX out of sys.modules."""
    code = ("import sys, pkgutil, importlib\n"
            "import gaussian_process_edge_trace_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'gaussian_process_edge_trace_tpu'))]\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
