"""PyTorch port, ``models/sklearn_api.py`` and ``models/lbfgs.py``: the
float64 ``GaussianProcessRegressor`` against the JAX package's class (x64
on, relative 1e-9 where both compute the same fit) and against the
installed sklearn, as ``tests/test_sklearn_api.py`` holds the JAX one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.gaussian_process as skgp
import sklearn.gaussian_process.kernels as skk
import torch

from gaussian_process_edge_trace_torch.models import sklearn_api as P
from gaussian_process_edge_trace_torch.models.lbfgs import minimize_lbfgs_b
from gaussian_process_edge_trace_tpu.models import sklearn_api as R
from gaussian_process_edge_trace_tpu.models.lbfgs import (
    minimize_lbfgs_b as ref_lbfgs)

torch.set_num_threads(1)

REL = 1e-9


def _data(n=14, seed=0):
    rng = np.random.RandomState(seed)
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) * 3 + rng.normal(0, 0.1, n)
    return x.reshape(-1, 1), y


def _gpr(M, kernel, **kw):
    if M is P:
        kw["device"] = "cpu"
    return M.GaussianProcessRegressor(kernel=kernel, **kw)


def _both(make_kernel, X, y, **kw):
    return (_gpr(P, make_kernel(P), **kw).fit(X, y),
            _gpr(R, make_kernel(R), **kw).fit(X, y))


@pytest.mark.parametrize("kind", ["RBF", "Matern1.5", "Matern2.5"])
def test_predict_std_cov_match_reference_and_sklearn(kind):
    X, y = _data()

    def kernel(M):
        if kind == "RBF":
            return M.ConstantKernel(4.0, "fixed") * M.RBF(1.5, "fixed")
        return M.ConstantKernel(4.0, "fixed") * M.Matern(
            1.5, nu=float(kind[-3:]))
    ours, ref = _both(kernel, X, y, alpha=1e-4, optimizer=None)
    Xq = np.linspace(-1, 11, 37)
    m1, s1 = ours.predict(Xq, return_std=True)
    m2, s2 = ref.predict(Xq, return_std=True)
    np.testing.assert_allclose(m1, m2, rtol=REL, atol=1e-12)
    np.testing.assert_allclose(s1, s2, rtol=REL, atol=1e-12)
    _, c1 = ours.predict(Xq, return_cov=True)
    _, c2 = ref.predict(Xq, return_cov=True)
    np.testing.assert_allclose(c1, c2, rtol=REL, atol=1e-12)
    # The fork's normalize_y=False is stock sklearn's normalize_y=True.
    sk_k = (skk.ConstantKernel(4.0, "fixed") * skk.RBF(1.5, "fixed")
            if kind == "RBF" else skk.ConstantKernel(4.0, "fixed")
            * skk.Matern(1.5, nu=float(kind[-3:])))
    sk = skgp.GaussianProcessRegressor(kernel=sk_k, alpha=1e-4,
                                       optimizer=None,
                                       normalize_y=True).fit(X, y)
    m3, s3 = sk.predict(Xq[:, None], return_std=True)
    np.testing.assert_allclose(m1, m3, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(s1, s3, rtol=1e-6, atol=1e-8)


def test_lml_and_gradient_match_reference_and_sklearn():
    X, y = _data()

    def kernel(M):
        return (M.ConstantKernel(2.0) * M.RBF(1.2)
                + M.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.3))
    ours, ref = _both(kernel, X, y, alpha=1e-10, optimizer=None)
    theta = np.log([2.0, 1.2, 0.3])
    v1, g1 = ours.log_marginal_likelihood(theta, eval_gradient=True)
    v2, g2 = ref.log_marginal_likelihood(theta, eval_gradient=True)
    np.testing.assert_allclose(v1, v2, rtol=REL)
    np.testing.assert_allclose(g1, g2, rtol=REL, atol=1e-12)
    assert ours.log_marginal_likelihood() == pytest.approx(
        ref.log_marginal_likelihood(), rel=REL)
    sk = skgp.GaussianProcessRegressor(
        kernel=skk.ConstantKernel(2.0) * skk.RBF(1.2) + skk.WhiteKernel(0.3),
        alpha=1e-10, optimizer=None, normalize_y=True).fit(X, y)
    v3, g3 = sk.log_marginal_likelihood(theta, eval_gradient=True)
    np.testing.assert_allclose(v1, v3, rtol=REL)
    np.testing.assert_allclose(g1, g3, rtol=1e-6, atol=1e-8)
    # A Gram that is not positive definite: −inf, a zero gradient.
    v, g = ours.log_marginal_likelihood(np.log([1e6, 50.0, 1e-300]),
                                        eval_gradient=True)
    assert v == -np.inf and np.all(g == 0)


def test_optimized_fit_reaches_reference_lml():
    """L-BFGS from the kernel's θ and 8 restarts: the port's optimum LML
    within 1e-6 relative of the JAX fit's (the restarts differ; both reach
    the same optimum), at least sklearn's less 0.5, and a fit that then
    predicts as the reference's to 1e-6."""
    X, y = _data(n=20, seed=3)

    def kernel(M):
        return (M.ConstantKernel(1.0, (1e-2, 1e3)) * M.RBF(1.0, (1e-2, 1e2))
                + M.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.1,
                                        noise_level_bounds=(1e-6, 1.0)))
    ours, ref = _both(kernel, X, y, alpha=1e-10, n_restarts_optimizer=8,
                      random_state=0)
    np.testing.assert_allclose(ours.log_marginal_likelihood_value_,
                               ref.log_marginal_likelihood_value_, rtol=1e-6)
    Xq = np.linspace(0, 10, 21)
    np.testing.assert_allclose(ours.predict(Xq), ref.predict(Xq), rtol=1e-6,
                               atol=1e-6)
    sk = skgp.GaussianProcessRegressor(
        kernel=(skk.ConstantKernel(1.0, (1e-2, 1e3))
                * skk.RBF(1.0, (1e-2, 1e2))
                + skk.WhiteKernel(0.1, (1e-6, 1.0))),
        alpha=1e-10, n_restarts_optimizer=8, random_state=0,
        normalize_y=True).fit(X, y)
    assert ours.log_marginal_likelihood_value_ > \
        sk.log_marginal_likelihood(sk.kernel_.theta) - 0.5
    # The user's kernel object is not changed (the fork clones).
    k = kernel(P)
    P.GaussianProcessRegressor(kernel=k, device="cpu").fit(X, y)
    assert k.signal.k1.constant_value == 1.0


def test_lbfgs_matches_reference_on_a_bounded_problem():
    """A Rosenbrock valley with an active bound, four starts stepping
    together: each start's iterate and value as the JAX function's vmapped
    over the starts, after ten steps (and the same step counts) and at the
    end."""
    lb = np.array([-2.0, -1.0])
    ub = np.array([2.0, 0.8])

    def rosen_t(x):
        x = x.detach().requires_grad_(True)
        f = (1 - x[:, 0]) ** 2 + 100 * (x[:, 1] - x[:, 0] ** 2) ** 2
        return f.detach(), torch.autograd.grad(f.sum(), x)[0]

    def rosen_j(x):
        return ((1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2)
    starts = np.array([[-1.5, 0.5], [0.0, 0.0], [1.9, -0.9], [0.5, 0.7]])
    for iters in (10, 80):
        got = minimize_lbfgs_b(rosen_t, torch.tensor(starts), lb, ub,
                               max_iters=iters)
        ref = jax.vmap(lambda s: ref_lbfgs(
            jax.value_and_grad(rosen_j), s, jnp.asarray(lb),
            jnp.asarray(ub), max_iters=iters))(jnp.asarray(starts))
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f),
                                   rtol=1e-9, atol=1e-12)
        if iters == 10:
            # Near convergence the stopping test (projected gradient below
            # 1e-9) turns on rounding; ten steps stop alike.
            np.testing.assert_array_equal(got.n_iters.numpy(),
                                          np.asarray(ref.n_iters))
    assert np.all(got.x.numpy()[:, 1] <= 0.8)


def test_normalize_y_matches_reference():
    """The fork's normalize_y=True removes the mean only, yet predict
    rescales: shift-equivariant, and the reference's values."""
    X, y = _data()

    def kernel(M):
        return M.ConstantKernel(4.0, "fixed") * M.RBF(1.5, "fixed")
    Xq = np.linspace(0, 10, 11)
    ours, ref = _both(kernel, X, y, alpha=1e-4, optimizer=None,
                      normalize_y=True)
    m0 = ours.predict(Xq)
    np.testing.assert_allclose(m0, ref.predict(Xq), rtol=REL)
    m_shift = _gpr(P, kernel(P), alpha=1e-4, optimizer=None,
                   normalize_y=True).fit(X, y + 100.0).predict(Xq)
    np.testing.assert_allclose(m_shift - m0, 100.0, rtol=0, atol=1e-6)


def test_weighted_noise_matches_manual_gram_and_reference():
    X, y = _data(n=9, seed=5)
    w = np.array([1e-7, 1, 1, 1, 0.5, 1, 1, 1, 1e-7])

    def kernel(M):
        return (M.ConstantKernel(4.0, "fixed") * M.RBF(1.5, "fixed")
                + M.WeightedWhiteKernel(noise_weight=w, noise_level=0.7))
    ours, ref = _both(kernel, X, y, alpha=1e-6, optimizer=None)
    x = X.ravel()
    K = 4.0 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 1.5 ** 2)
    K[np.diag_indices_from(K)] += 0.7 * w + 1e-6
    Xq = np.linspace(0, 10, 7)
    Ks = 4.0 * np.exp(-0.5 * (Xq[:, None] - x[None, :]) ** 2 / 1.5 ** 2)
    m, sd = y.mean(), y.std()
    want = sd * (Ks @ np.linalg.solve(K, (y - m) / sd)) + m
    np.testing.assert_allclose(ours.predict(Xq), want, rtol=1e-7)
    np.testing.assert_allclose(ours.predict(Xq), ref.predict(Xq), rtol=REL)


def test_sample_y_statistics_and_injected_normals():
    """Monte-Carlo mean and std of 4000 draws at 4σ; from the JAX
    package's own normals (``PRNGKey(1)`` split as its ``sample_y`` splits
    it) the port's Matheron draw equals the reference's within 1e-10."""
    X, y = _data()

    def kernel(M):
        return (M.ConstantKernel(4.0, "fixed") * M.RBF(1.5, "fixed")
                + M.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.05))
    ours, ref = _both(kernel, X, y, alpha=1e-8, optimizer=None)
    Xq = np.linspace(0, 10, 25)
    mean, std = ours.predict(Xq, return_std=True)
    s = ours.sample_y(Xq, n_samples=4000, random_state=1)
    assert s.shape == (25, 4000)
    np.testing.assert_allclose(s.mean(axis=1), mean, atol=0.13)
    np.testing.assert_allclose(s.std(axis=1), std, atol=0.13)
    np.testing.assert_array_equal(s, ours.sample_y(Xq, 4000, 1))
    assert not np.allclose(s[:, :100], ours.sample_y(Xq, 100, 2))
    kp, kn = jax.random.split(jax.random.PRNGKey(1))
    nq, n, S = 25, X.shape[0], 50
    z = np.asarray(jax.random.normal(kp, (nq + n, S), jnp.float64))
    w = np.asarray(jax.random.normal(kn, (n, S), jnp.float64))
    np.testing.assert_allclose(
        ours._sample_from(Xq, [(z, w)]),
        np.asarray(ref.sample_y(Xq, n_samples=S, random_state=1)),
        rtol=1e-10, atol=1e-10)
    assert len(ours._prior_factor_cache) == 1


def test_prior_predict_and_sample_before_fit():
    for M in (P, R):
        gp = _gpr(M, M.ConstantKernel(4.0, "fixed") * M.RBF(1.5, "fixed"),
                  optimizer=None)
        m, s = gp.predict(np.arange(5.0), return_std=True)
        np.testing.assert_allclose(np.asarray(m), 0.0)
        np.testing.assert_allclose(np.asarray(s), 2.0)
        draws = np.asarray(gp.sample_y(np.arange(5.0), n_samples=2000,
                                       random_state=0))
        assert draws.shape == (5, 2000)
        np.testing.assert_allclose(draws.std(axis=1), 2.0, atol=0.15)
    _, cov = gp.predict(np.arange(5.0), return_cov=True)
    _, pcov = _gpr(P, P.ConstantKernel(4.0, "fixed") * P.RBF(1.5, "fixed"),
                   optimizer=None).predict(np.arange(5.0), return_cov=True)
    np.testing.assert_allclose(pcov, np.asarray(cov), rtol=REL)


def test_score_r2_matches_reference():
    X, y = _data(n=25, seed=9)

    def kernel(M):
        return (M.ConstantKernel(4.0, "fixed") * M.RBF(1.5, "fixed")
                + M.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.01))
    ours, ref = _both(kernel, X, y, alpha=1e-8, optimizer=None)
    assert ours.score(X, y) > 0.98
    assert ours.score(X, y) == pytest.approx(ref.score(X, y), rel=REL)


def test_multi_output_matches_reference_and_sklearn():
    """(n, 3) targets: per-column posteriors on one Cholesky factor, the
    summed LML, (nq, nq, 3) covariances, (nq, 3, S) draws; (n, 1) targets
    squeeze as the fork squeezes them."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 10, 17))
    Y = np.stack([np.sin(X) + 5.0, np.cos(X) * 3.0 - 2.0, 0.3 * X], axis=1)
    Xq = np.linspace(-1, 11, 23)

    def kernel(M):
        return M.ConstantKernel(2.0, "fixed") * M.RBF(1.5, "fixed")
    ours, ref = _both(kernel, X, Y, alpha=1e-6, optimizer=None)
    m_o, s_o = ours.predict(Xq, return_std=True)
    m_r, s_r = ref.predict(Xq, return_std=True)
    assert m_o.shape == s_o.shape == (23, 3)
    np.testing.assert_allclose(m_o, m_r, rtol=REL, atol=1e-12)
    np.testing.assert_allclose(s_o, s_r, rtol=REL, atol=1e-12)
    _, c_o = ours.predict(Xq, return_cov=True)
    _, c_r = ref.predict(Xq, return_cov=True)
    assert c_o.shape == (23, 23, 3)
    np.testing.assert_allclose(c_o, c_r, rtol=REL, atol=1e-12)
    lml = np.log([2.0, 1.5, 1e-300])
    assert ours.log_marginal_likelihood(lml) == pytest.approx(
        ref.log_marginal_likelihood(lml), rel=REL)
    sk = skgp.GaussianProcessRegressor(
        kernel=skk.ConstantKernel(2.0, "fixed") * skk.RBF(1.5, "fixed"),
        alpha=1e-6, optimizer=None, normalize_y=True).fit(X[:, None], Y)
    m_s, s_s = sk.predict(Xq[:, None], return_std=True)
    np.testing.assert_allclose(m_o, m_s, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s_o, s_s, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours.log_marginal_likelihood(lml),
                               sk.log_marginal_likelihood(), rtol=1e-5)
    s = ours.sample_y(Xq, n_samples=4000, random_state=1)
    assert s.shape == (23, 3, 4000)
    np.testing.assert_allclose(s.mean(axis=-1), m_o, atol=0.25)
    one = _gpr(P, kernel(P), alpha=1e-6, optimizer=None).fit(X, Y[:, :1])
    assert one.predict(Xq).shape == (23,)
    assert ours.score(X, Y) > 0.99


@pytest.mark.parametrize("shape", ["c_rbf", "c_matern", "c_rbf_white",
                                   "bare_rbf"])
def test_accepts_stock_sklearn_kernel_objects(shape):
    """Stock sklearn kernels of the shapes the reference composes give the
    fit of the native kernel objects exactly, and the reference's."""
    X, y = _data()
    if shape == "c_rbf":
        sk_k = skk.ConstantKernel(4.0, (1e-3, 1e3)) * skk.RBF(1.5, "fixed")
        our_k = P.ConstantKernel(4.0, (1e-3, 1e3)) * P.RBF(1.5, "fixed")
    elif shape == "c_matern":
        sk_k = skk.ConstantKernel(4.0, "fixed") * skk.Matern(2.0, nu=1.5)
        our_k = P.ConstantKernel(4.0, "fixed") * P.Matern(2.0, nu=1.5)
    elif shape == "c_rbf_white":
        sk_k = (skk.ConstantKernel(4.0, "fixed") * skk.RBF(1.5, "fixed")
                + skk.WhiteKernel(0.05, "fixed"))
        our_k = (P.ConstantKernel(4.0, "fixed") * P.RBF(1.5, "fixed")
                 + P.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.05,
                                         noise_level_bounds="fixed"))
    else:
        sk_k = skk.RBF(1.5, "fixed")
        our_k = P.RBF(1.5, "fixed")
    Xq = np.linspace(-1, 11, 29)
    a = _gpr(P, sk_k, alpha=1e-4, optimizer=None).fit(X, y)
    b = _gpr(P, our_k, alpha=1e-4, optimizer=None).fit(X, y)
    r = _gpr(R, sk_k, alpha=1e-4, optimizer=None).fit(X, y)
    ma, sa = a.predict(Xq, return_std=True)
    mb, sb = b.predict(Xq, return_std=True)
    mr, sr = r.predict(Xq, return_std=True)
    np.testing.assert_array_equal(ma, mb)
    np.testing.assert_array_equal(sa, sb)
    np.testing.assert_allclose(ma, mr, rtol=REL, atol=1e-12)
    np.testing.assert_allclose(sa, sr, rtol=REL, atol=1e-12)


def test_stock_sklearn_kernel_rejections():
    with pytest.raises(TypeError, match="supported shapes"):
        _gpr(P, skk.DotProduct()).fit(*_data())
    with pytest.raises(TypeError, match="anisotropic"):
        _gpr(P, skk.RBF([1.0, 2.0])).fit(
            np.random.RandomState(0).rand(5, 2), np.zeros(5))
    with pytest.raises(NotImplementedError):
        P.Matern(1.0, nu=0.5)
    with pytest.raises(TypeError):
        P.WeightedWhiteKernel() + P.RBF()


def test_float64_on_the_device_through_the_library():
    """The fit's factor and its dual coefficients are float64 tensors on
    the regressor's device, and the class defaults to the card."""
    X, y = _data()
    gp = _gpr(P, P.ConstantKernel(4.0, "fixed") * P.RBF(1.5, "fixed"),
              optimizer=None).fit(X, y)
    assert gp._L.dtype == gp._alpha_multi.dtype == torch.float64
    assert gp._L.device.type == "cpu"
    assert P.GaussianProcessRegressor().device.type == "cuda"


def test_optimum_resolved_past_the_rounding():
    """The optimised fit does not move with the data's last bits: y scaled
    by 1 + 1e-15 moves the predictions by less than 1e-11 relative (L-BFGS
    alone, whose Armijo search compares values that differ by less than
    their rounding near the optimum, moved them by ~1e-8, as the card's
    rounding in place of the CPU's did); the Newton polish does not lower
    the LML, and the polished fit is the JAX package's L-BFGS fit within
    the resolution of its Armijo search: θ within 1e-7 (it reads 2.7e-8
    apart), the predictions within 1e-6 relative (1.1e-7 and 1.5e-8)."""
    X, y = _data(n=40, seed=5)

    def fit(scale):
        kernel = (P.ConstantKernel(1.0, (1e-2, 1e3)) * P.RBF(1.0, (1e-1, 1e3))
                  + P.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.1,
                                          noise_level_bounds=(1e-6, 10.0)))
        return _gpr(P, kernel, alpha=1e-6, n_restarts_optimizer=4,
                    random_state=0).fit(X, y * scale)
    a, b = fit(1.0), fit(1.0 + 1e-15)
    Xq = np.linspace(0, 10, 31)
    (ma, sa), (mb, sb) = (g.predict(Xq, return_std=True) for g in (a, b))
    np.testing.assert_allclose(mb, ma, rtol=1e-11, atol=0)
    np.testing.assert_allclose(sb, sa, rtol=1e-11, atol=0)
    kernel = (R.ConstantKernel(1.0, (1e-2, 1e3)) * R.RBF(1.0, (1e-1, 1e3))
              + R.WeightedWhiteKernel(noise_weight=1.0, noise_level=0.1,
                                      noise_level_bounds=(1e-6, 10.0)))
    ref = _gpr(R, kernel, alpha=1e-6, n_restarts_optimizer=4,
               random_state=0).fit(X, y)
    assert a.log_marginal_likelihood_value_ >= \
        ref.log_marginal_likelihood_value_ - 1e-9

    def theta(g):
        k = g._kernel_
        return np.log([k.signal.k1.constant_value, k.signal.k2.length_scale,
                       k.noise.noise_level])
    np.testing.assert_allclose(theta(a), theta(ref), rtol=0, atol=1e-7)
    mr, sr = ref.predict(Xq, return_std=True)
    np.testing.assert_allclose(ma, mr, rtol=1e-6, atol=0)
    np.testing.assert_allclose(sa, sr, rtol=1e-6, atol=0)
