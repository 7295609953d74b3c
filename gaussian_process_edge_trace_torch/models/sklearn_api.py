"""sklearn-style Gaussian-process regression on PyTorch, in float64.

Port of ``gaussian_process_edge_trace_tpu/models/sklearn_api.py``. The
reference package exports its vendored ``GaussianProcessRegressor`` fork and
``WeightedWhiteKernel`` (reference: __init__.py:10-15,
sklearn_gpr.py:31-610,617-721); users compose them with stock sklearn
``ConstantKernel``/``RBF``/``Matern`` (gpet.py:165-178). The same surface:

- kernel objects :class:`ConstantKernel`, :class:`RBF`, :class:`Matern`,
  :class:`WeightedWhiteKernel`, composed as ``C * RBF + W`` (the only shape
  the reference builds), and stock sklearn kernels of those shapes, read by
  their attributes without importing sklearn;
- :class:`GaussianProcessRegressor` with ``fit`` / ``predict`` /
  ``sample_y`` / ``log_marginal_likelihood`` / ``score``, multi-output
  targets, and L-BFGS hyperparameter optimisation from restarts
  (sklearn_gpr.py:254-295) that step together
  (:func:`..models.lbfgs.minimize_lbfgs_b`);
- the fork's deltas: ``normalize_y`` removes the mean without scaling while
  ``predict`` still rescales (sklearn_gpr.py:225-240,385,401), no hard
  convergence check (sklearn_gpr.py:596-599), and observation noise in the
  training Gram only, where the fork sniffed query shapes
  (sklearn_gpr.py:672-677).

It computes in float64, as its reference does (x64 on), on ``device``
(``"cuda"`` by default). Its Cholesky factors, solves and LML go through
``torch.linalg`` (:func:`..models.gpr.library_lml` and
:func:`..models.gpr.safe_cholesky` without its per-matrix kernel route): the
JAX package computes them with XLA outside any Pallas kernel, and the K5/K6
kernels take float32 only. Gradients come from ``torch.autograd``. Random
draws (restarts, ``sample_y``) are the JAX package's float64 draws of
``PRNGKey(random_state)`` keyed as with x64 on (``ops/prng.py::
prng_key_x64``), made on the CPU and moved to
the device, so the card and the CPU start from the same numbers.

Inputs are (n, 1) or (n,) arrays of scalar locations, the only input shape
the reference supports in practice (pixel columns).
"""

from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from gaussian_process_edge_trace_torch.models.gpr import (
    library_lml, safe_cholesky)
from gaussian_process_edge_trace_torch.models.kernels import (
    KernelSpec, cross_gram, k_unit_np, train_gram)
from gaussian_process_edge_trace_torch.models.lbfgs import minimize_lbfgs_b
from gaussian_process_edge_trace_torch.ops import prng

_F64 = torch.float64


def _as_bounds(b):
    if b == "fixed" or b is None:
        return None
    lo, hi = b
    return (float(lo), float(hi))


class ConstantKernel:
    """Scalar variance factor (sklearn ConstantKernel)."""

    def __init__(self, constant_value=1.0, constant_value_bounds=(1e-5, 1e5)):
        self.constant_value = float(constant_value)
        self.constant_value_bounds = constant_value_bounds

    def __mul__(self, other):
        return _ProductKernel(self, other)


class RBF:
    def __init__(self, length_scale=1.0, length_scale_bounds=(1e-5, 1e5)):
        self.length_scale = float(length_scale)
        self.length_scale_bounds = length_scale_bounds
        self.spec = KernelSpec(kind="RBF")


class Matern:
    def __init__(self, length_scale=1.0, nu=2.5,
                 length_scale_bounds=(1e-5, 1e5)):
        if nu not in (1.5, 2.5):
            raise NotImplementedError(
                "only nu in {1.5, 2.5} (the closed forms the reference "
                "instantiates, gpet.py:134,143)")
        self.length_scale = float(length_scale)
        self.nu = float(nu)
        self.length_scale_bounds = length_scale_bounds
        self.spec = KernelSpec(kind="Matern", nu=float(nu))


class WeightedWhiteKernel:
    """Heteroscedastic white noise: ``noise_level * diag(noise_weight)``
    on the training Gram (sklearn_gpr.py:617-721, minus the query-shape
    hack — query covariance is noise-free by construction).

    ``edge_length`` is accepted for signature compatibility and ignored —
    it only existed to power the shape-sniffing hack."""

    def __init__(self, edge_length=None, noise_weight=1.0, noise_level=1.0,
                 noise_level_bounds=(1e-5, 1e5)):
        self.edge_length = edge_length
        self.noise_weight = np.asarray(noise_weight, dtype=np.float64)
        self.noise_level = float(noise_level)
        self.noise_level_bounds = noise_level_bounds

    def __radd__(self, other):
        return _CompositeKernel(other, self)

    def __add__(self, other):
        raise TypeError("WeightedWhiteKernel is additive noise; compose as "
                        "signal_kernel + WeightedWhiteKernel")


class _ProductKernel:
    """ConstantKernel * (RBF | Matern) — the reference's signal kernel
    (gpet.py:165-178)."""

    def __init__(self, const: ConstantKernel, stationary):
        if not isinstance(const, ConstantKernel):
            raise TypeError("left factor must be ConstantKernel")
        if not isinstance(stationary, (RBF, Matern)):
            raise TypeError("right factor must be RBF or Matern")
        self.k1 = const
        self.k2 = stationary

    def __add__(self, noise):
        if not isinstance(noise, WeightedWhiteKernel):
            raise TypeError("additive term must be WeightedWhiteKernel")
        return _CompositeKernel(self, noise)


class _CompositeKernel(NamedTuple):
    """signal (ConstantKernel*stationary) + WeightedWhiteKernel."""
    signal: _ProductKernel
    noise: WeightedWhiteKernel


def _from_sklearn(k):
    """Convert a stock ``sklearn.gaussian_process.kernels`` expression of
    the shapes the reference composes — ``C * RBF|Matern`` optionally
    ``+ WhiteKernel`` (sklearn_gpr.py:140-180, gpet.py:165-178) — into the
    native kernel objects, by attribute introspection (no sklearn import
    needed). Raises TypeError naming the supported set otherwise."""
    name = type(k).__name__
    if name == "Product":
        return _from_sklearn(k.k1) * _from_sklearn(k.k2)
    if name == "Sum":
        left = _from_sklearn(k.k1)
        if isinstance(left, (RBF, Matern)):
            left = _ProductKernel(ConstantKernel(1.0, "fixed"), left)
        return left + _from_sklearn(k.k2)
    if name == "ConstantKernel":
        return ConstantKernel(k.constant_value, k.constant_value_bounds)
    if name in ("RBF", "Matern"):
        ls = np.asarray(k.length_scale, dtype=np.float64).reshape(-1)
        if ls.size != 1:
            raise TypeError("anisotropic length_scale is not supported "
                            "(the reference only fits 1-D inputs)")
        if name == "RBF":
            return RBF(float(ls[0]), k.length_scale_bounds)
        return Matern(float(ls[0]), nu=float(k.nu),
                      length_scale_bounds=k.length_scale_bounds)
    if name in ("WhiteKernel", "WeightedWhiteKernel"):
        return WeightedWhiteKernel(
            noise_weight=getattr(k, "noise_weight", 1.0),
            noise_level=float(k.noise_level),
            noise_level_bounds=k.noise_level_bounds)
    raise TypeError(
        f"unsupported sklearn kernel component {name!r}: supported shapes "
        "are ConstantKernel * (RBF | Matern) [+ WhiteKernel]")


def _normalise_kernel(kernel):
    """Coerce any supported kernel expression to a _CompositeKernel with
    zero-noise default. Stock sklearn kernel objects (identified by
    module) are converted by introspection first (sklearn_gpr.py:140-180
    accepts arbitrary sklearn kernels; we support the composition shapes
    the reference builds)."""
    if type(kernel).__module__.split(".")[0] == "sklearn":
        return _normalise_kernel(_from_sklearn(kernel))
    if isinstance(kernel, _CompositeKernel):
        return kernel
    if isinstance(kernel, _ProductKernel):
        return _CompositeKernel(kernel, WeightedWhiteKernel(
            noise_weight=0.0, noise_level=0.0, noise_level_bounds="fixed"))
    if isinstance(kernel, (RBF, Matern)):
        return _CompositeKernel(
            _ProductKernel(ConstantKernel(1.0, "fixed"), kernel),
            WeightedWhiteKernel(noise_weight=0.0, noise_level=0.0,
                                noise_level_bounds="fixed"))
    raise TypeError(f"unsupported kernel expression: {kernel!r}")


def _newton_polish(fun, x, fx, lb, ub, steps=3, h=1e-6):
    """Newton steps on the gradient from L-BFGS's optimum ``x`` (value
    ``fx``) over the dimensions that lie inside their bounds. The Armijo
    search accepts steps by their values, which near a flat optimum differ
    by less than their float64 rounding, so L-BFGS resolves the optimum
    only to about the square root of it (1e-8 relative): a change of the
    data at the rounding's level, or the card's rounding in place of the
    CPU's, moves its result that far. The gradient keeps resolving it. The
    Hessian is the central difference of the gradient; a step is kept when
    it shrinks the gradient without raising the value beyond rounding.

    A stage of the port's own: the JAX package returns L-BFGS's best start
    as it stands (sklearn_api.py:331). The polished θ lies within that
    search's resolution of the JAX package's (tests/test_torch_sklearn.py::
    test_optimum_resolved_past_the_rounding)."""
    d = x.shape[-1]
    free = (x > lb + h) & (x < ub - h)
    n = int(free.sum())
    if n == 0:
        return x, fx
    idx = torch.nonzero(free)[:, 0]
    eye = torch.eye(d, dtype=x.dtype, device=x.device)[idx]   # (n, d)
    _, g = fun(x[None])
    g = g[0]
    for _ in range(steps):
        _, gs = fun(torch.cat([x[None] + h * eye, x[None] - h * eye]))
        H = ((gs[:n] - gs[n:]) / (2 * h))[:, idx]
        H = 0.5 * (H + H.T)
        step = torch.linalg.solve_ex(H, -g[idx]).result
        if not bool(torch.isfinite(step).all()):
            break
        xn = torch.minimum(torch.maximum(x.index_add(0, idx, step), lb), ub)
        fn, gn = fun(xn[None])
        fn, gn = fn[0], gn[0]
        if not (bool(torch.isfinite(fn)) and float(gn[idx].abs().max())
                < float(g[idx].abs().max())
                and float(fn) <= float(fx) + 1e-12 * abs(float(fx))):
            break
        x, fx, g = xn, fn, gn
    return x, fx


class GaussianProcessRegressor:
    """GPR with the reference fork's semantics, in float64 on ``device``.

    Parameters follow sklearn_gpr.py:31-180: ``kernel``, ``alpha`` (diagonal
    jitter), ``optimizer`` (``'fmin_l_bfgs_b'`` or ``None``),
    ``n_restarts_optimizer``, ``normalize_y`` (mean removal only, the
    fork's delta), ``random_state``; keyword-only ``device``.
    """

    def __init__(self, kernel=None, alpha=1e-10, optimizer="fmin_l_bfgs_b",
                 n_restarts_optimizer=0, normalize_y=False,
                 copy_X_train=True, random_state=None, *, device="cuda"):
        self.kernel = kernel
        self.alpha = alpha
        self.optimizer = optimizer
        self.n_restarts_optimizer = int(n_restarts_optimizer)
        self.normalize_y = bool(normalize_y)
        self.copy_X_train = copy_X_train
        self.random_state = 0 if random_state is None else int(random_state)
        self.device = torch.device(device)

    # -- internals ----------------------------------------------------------

    def _t(self, a):
        return torch.as_tensor(np.array(a, np.float64), dtype=_F64,
                               device=self.device)

    def _params(self):
        k = self._kernel_
        return (k.signal.k2.spec, k.signal.k1.constant_value,
                k.signal.k2.length_scale, k.noise.noise_level)

    def _noise_weight(self, n):
        return self._t(np.broadcast_to(self._kernel_.noise.noise_weight,
                                       (n,)))

    def _diag_noise(self, n):
        return self._params()[3] * self._noise_weight(n) + self.alpha

    def _lml_fn(self, y_proc):
        """θ (..., 3) -> the LML summed over the target columns, from the
        fork-transformed targets (n, m); the training set's tensors are
        made once."""
        n = len(self.X_train_)
        args = (self._kernel_.signal.k2.spec, self._t(self.X_train_),
                self._t(y_proc),
                torch.ones(n, dtype=torch.bool, device=self.device))
        nw = self._noise_weight(n)

        def lml(thetas):
            return library_lml(*args, thetas, nw, jitter=self.alpha)
        return lml

    def _y_transform(self, y):
        """The fork's target transform (sklearn_gpr.py:220-240): centre
        only under normalize_y=True, centre and scale under
        normalize_y=False; ``predict`` rescales by ``_y_train_std`` either
        way (sklearn_gpr.py:385,401). A zero std maps to 1
        (_handle_zeros_in_scale); per column for 2-D targets."""
        m = np.mean(y, axis=0)
        s = np.std(y, axis=0)
        s = np.where(s == 0.0, 1.0, s)
        y_proc = (y - m) if self.normalize_y else (y - m) / s
        return y_proc, m, s

    # -- API ------------------------------------------------------------------

    def fit(self, X, y):
        if self.kernel is None:
            # Fork default: both hyperparameters fixed (sklearn_gpr.py:
            # 198-201), so the default configuration skips optimisation.
            self.kernel = ConstantKernel(1.0, "fixed") * RBF(
                1.0, length_scale_bounds="fixed")
        # Optimise a copy: the fork clones (sklearn_gpr.py:203).
        self._kernel_ = _normalise_kernel(copy.deepcopy(self.kernel))
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=np.float64)
        # Multi-output y (n, m): per-column posteriors sharing one Gram
        # (sklearn_gpr.py:211-218).
        self._n_targets = None if y.ndim == 1 else y.shape[1]
        self.X_train_ = X
        self.y_train_ = y
        y_proc, self._y_train_mean, self._y_train_std = self._y_transform(
            y.reshape(len(X), -1))
        k = self._kernel_
        any_free = any(_as_bounds(b) is not None
                       for b in (k.signal.k1.constant_value_bounds,
                                 k.signal.k2.length_scale_bounds,
                                 k.noise.noise_level_bounds))
        if self.optimizer is not None and any_free:
            self._optimize_theta(y_proc)
        spec, c, ls, _ = self._params()
        self._x = self._t(X)
        K = train_gram(spec, self._x, ls, c, self._diag_noise(len(X)))
        self._L = safe_cholesky(K)
        self._y_proc = y_proc                                # (n, m)
        self._alpha_multi = torch.cholesky_solve(self._t(y_proc), self._L)
        self.kernel_ = self._kernel_
        return self

    def _optimize_theta(self, y_proc):
        """Maximise the LML over the free hyperparameters (θ = [log c,
        log ℓ, log σn²], fixed dimensions pinned by equal bounds) from the
        kernel's θ and ``n_restarts_optimizer`` uniform starts, all
        stepping together."""
        k = self._kernel_
        bounds = (_as_bounds(k.signal.k1.constant_value_bounds),
                  _as_bounds(k.signal.k2.length_scale_bounds),
                  _as_bounds(k.noise.noise_level_bounds))
        theta0 = np.log([max(k.signal.k1.constant_value, 1e-300),
                         k.signal.k2.length_scale,
                         max(k.noise.noise_level, 1e-300)])
        lb = np.array([np.log(b[0]) if b else t
                       for b, t in zip(bounds, theta0)])
        ub = np.array([np.log(b[1]) if b else t
                       for b, t in zip(bounds, theta0)])

        lml = self._lml_fn(y_proc)

        def fun(th):
            th = th.detach().requires_grad_(True)
            v = -lml(th)
            g, = torch.autograd.grad(v.sum(), th)
            return v.detach(), g

        def values(th):
            with torch.no_grad():
                return -lml(th)

        # The JAX package's float64 uniforms of PRNGKey(random_state)
        # (sklearn_api.py:319-321), keyed as with x64 on.
        restarts = prng.uniform64_plain(
            prng.prng_key_x64(self.random_state),
            (self.n_restarts_optimizer, 3)).numpy() * (ub - lb) + lb
        starts = self._t(np.concatenate([theta0[None], restarts]))
        res = minimize_lbfgs_b(fun, starts, self._t(lb), self._t(ub),
                               max_iters=64, values=values)
        f = res.f.cpu().numpy()
        best = int(np.argmin(np.where(np.isfinite(f), f, np.inf)))
        x, fx = _newton_polish(fun, res.x[best], res.f[best],
                               self._t(lb), self._t(ub))
        theta = x.cpu().numpy()
        k.signal.k1.constant_value = float(np.exp(theta[0]))
        k.signal.k2.length_scale = float(np.exp(theta[1]))
        k.noise.noise_level = float(np.exp(theta[2]))
        self.log_marginal_likelihood_value_ = float(-fx)

    def _unscale(self, a, power=1):
        """Per-target rescale of (nq, [nq,] m) values by ``sd**power`` (and
        the mean for power 1), a trailing single target squeezed
        (sklearn_gpr.py:381-436)."""
        sd = self._y_train_std
        out = a * sd ** power + (self._y_train_mean if power == 1 else 0.0)
        return out[..., 0] if out.shape[-1] == 1 else out

    def predict(self, X, return_std=False, return_cov=False):
        """Posterior mean at ``X``, with the std or the covariance; before
        ``fit``, the prior's (zero mean, the kernel's variance,
        sklearn_gpr.py:363-378). numpy float64."""
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        if not hasattr(self, "_kernel_"):
            if self.kernel is None:
                self.kernel = ConstantKernel(1.0, "fixed") * RBF(1.0)
            self._kernel_ = _normalise_kernel(self.kernel)
        spec, c, ls, _ = self._params()
        xq = self._t(X)
        if not hasattr(self, "_L"):
            mean = np.zeros(X.shape[0])
            if return_cov:
                return mean, cross_gram(spec, xq, xq, ls, c).cpu().numpy()
            if return_std:
                return mean, np.sqrt(np.full(X.shape[0], c))
            return mean
        Kq = cross_gram(spec, xq, self._x, ls, c)
        y_mean = self._unscale((Kq @ self._alpha_multi).cpu().numpy())
        if not (return_std or return_cov):
            return y_mean
        V = torch.linalg.solve_triangular(self._L, Kq.T, upper=False)
        if return_cov:
            base = cross_gram(spec, xq, xq, ls, c) - V.T @ V
            return y_mean, self._unscale(base.cpu().numpy()[:, :, None], 2)
        var = torch.clamp(c - (V * V).sum(0), min=0.0).cpu().numpy()
        return y_mean, np.sqrt(self._unscale(var[:, None], 2))

    def _joint_prior_factor(self, Xq, spec, ls):
        """Unit-variance prior square root over query ∪ training points:
        a host float64 eigendecomposition, cached per (query grid, ℓ), as
        it depends on the prior alone."""
        key = (Xq.tobytes(), float(ls), spec)
        cache = getattr(self, "_prior_factor_cache", None)
        if cache is None:
            cache = self._prior_factor_cache = {}
        F = cache.get(key)
        if F is None:
            P = np.concatenate([Xq, self.X_train_])
            d = np.abs(P[:, None] - P[None, :]) / float(ls)
            K = k_unit_np(spec, d)
            K[np.diag_indices_from(K)] += 1e-10
            w, V = np.linalg.eigh(K)
            F = self._t(V * np.sqrt(np.clip(w, 0.0, None))[None, :])
            if len(cache) >= 4:
                cache.clear()
            cache[key] = F
        return F

    def _sample_from(self, X, normals):
        """Posterior draws at ``X`` from given normals, one ``(z (nq + n,
        S), w (n, S))`` pair per target, by Matheron's rule through the
        fit's Cholesky factor (the draw of sklearn_gpr.py:440-473):

            s = f₀(X*) + K(X*,X) (K+Σ)⁻¹ (y − f₀(X) − ε)

        with the joint prior path f₀ drawn through the cached prior factor.
        Returns (nq, S), or (nq, n_targets, S) for a multi-output fit."""
        spec, c, ls, _ = self._params()
        Xq = np.asarray(X, dtype=np.float64).reshape(-1)
        nq, n = Xq.shape[0], self.X_train_.shape[0]
        F = self._joint_prior_factor(Xq, spec, ls)
        Kq = cross_gram(spec, self._t(Xq), self._x, ls, c)
        sqrt_c = float(np.sqrt(c))
        sqrt_noise = torch.sqrt(torch.clamp(self._diag_noise(n), min=0.0))
        yp = self._t(self._y_proc)
        out = []
        for t, (z, w) in enumerate(normals):
            f0 = sqrt_c * (F @ self._t(z))                  # (nq+n, S)
            resid = yp[:, t, None] - f0[nq:] - sqrt_noise[:, None] * \
                self._t(w)
            s_proc = f0[:nq] + Kq @ torch.cholesky_solve(resid, self._L)
            # The fork's unconditional std rescale (sklearn_gpr.py:385,401).
            out.append((self._y_train_std[t] * s_proc.cpu().numpy()
                        + self._y_train_mean[t]))
        return out[0] if self._n_targets is None else np.stack(out, axis=1)

    def sample_y(self, X, n_samples=1, random_state=0):
        """``n_samples`` posterior draws at ``X`` (sklearn_gpr.py:440-473),
        (nq, S) or (nq, n_targets, S); before ``fit``, draws of the prior
        through its eigendecomposition. The float64 normals are the JAX
        package's (sklearn_api.py:428-475): ``split(PRNGKey(random_state))``
        into the prior and noise keys, per target of a multi-output fit
        ``split(fold_in(key, t))``, and the prior's normals of the unfolded
        key itself; drawn on the CPU (:func:`~..ops.prng.normal64_plain`)."""
        key = prng.prng_key_x64(int(random_state))
        S = int(n_samples)
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        if hasattr(self, "_L"):
            n = self.X_train_.shape[0]
            keys = ([key] if self._n_targets is None else
                    [prng.fold_in(key, t) for t in range(self._n_targets)])
            normals = []
            for k in keys:
                kp, kn = prng.split(k)
                normals.append((prng.normal64_plain(kp, (X.shape[0] + n, S)),
                                prng.normal64_plain(kn, (n, S))))
            return self._sample_from(X, normals)
        mean, cov = self.predict(X, return_cov=True)
        w, V = torch.linalg.eigh(self._t(cov))
        Fq = V * torch.sqrt(torch.clamp(w, min=0.0))[None, :]
        z = prng.normal64_plain(key, (cov.shape[0], S))
        return mean[:, None] + (Fq @ self._t(z)).cpu().numpy()

    def score(self, X, y):
        """Coefficient of determination R² (sklearn RegressorMixin.score;
        multi-output: the uniform average over target columns)."""
        y = np.asarray(y, dtype=np.float64)
        y2 = y.reshape(len(y), -1)
        p2 = np.asarray(self.predict(X)).reshape(y2.shape)

        def r2(yc, pc):
            u = np.sum((yc - pc) ** 2)
            v = np.sum((yc - yc.mean()) ** 2)
            if v == 0.0:
                # Constant targets: 1 for a perfect prediction, else 0.
                return 1.0 if u == 0.0 else 0.0
            return 1.0 - u / v

        return float(np.mean([r2(y2[:, t], p2[:, t])
                              for t in range(y2.shape[1])]))

    def log_marginal_likelihood(self, theta=None, eval_gradient=False):
        """LML (summed over targets) at ``theta`` (log c, log ℓ, log σn²),
        the fitted kernel's by default; with ``eval_gradient``, ``(value,
        gradient)``. −inf where the Gram is not positive definite."""
        spec, c, ls, nz = self._params()
        if theta is None:
            theta = np.log([c, ls, max(nz, 1e-300)])
        th = self._t(theta).requires_grad_(bool(eval_gradient))
        y_proc, _, _ = self._y_transform(
            np.asarray(self.y_train_).reshape(len(self.X_train_), -1))
        val = self._lml_fn(y_proc)(th)
        if eval_gradient:
            g, = torch.autograd.grad(val, th)
            return float(val.detach()), g.cpu().numpy()
        return float(val)
