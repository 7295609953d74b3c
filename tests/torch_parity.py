"""Shared pieces of the PyTorch-port parity tests (``test_torch_*.py``).

The port's tests run the JAX package and the port on the same float32
inputs. ``tests/conftest.py`` turns on JAX x64, so every reference input is
cast to float32 explicitly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


def t32(a, device="cpu"):
    """numpy/JAX array → float32 torch tensor (a copy)."""
    return torch.tensor(np.asarray(a, np.float32), device=device)


def j32(a):
    """numpy/torch array → float32 JAX array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return jnp.asarray(np.asarray(a, np.float32))


class JaxDraws:
    """A draw source for the port's ``run_trace`` that replays the JAX
    package's random streams: the keys ``run_trace`` splits per iteration
    (driver.py:394, gpr.py:208,233,238) and the final fit's restart
    uniforms (driver.py:590,640)."""

    def __init__(self, cfg, rank, device="cpu"):
        self.cfg, self.rank, self.device = cfg, rank, device
        self.key = jax.random.PRNGKey(cfg.seed)

    def normals(self, it, cols=slice(None)):
        """The iteration's (r, S) and (n_train, S) normals, or their columns
        ``cols``: a sample shard's slice of the full draws, as the
        reference's shards take them (gpr.py:189-200)."""
        k_prior, k_noise = jax.random.split(
            jax.random.fold_in(self.key, it + 1))
        S = self.cfg.N_samples
        z = jax.random.normal(k_prior, (self.rank, S), jnp.float32)
        w = jax.random.normal(k_noise, (self.cfg.n_train, S), jnp.float32)
        return (t32(np.asarray(z)[:, cols], self.device),
                t32(np.asarray(w)[:, cols], self.device))

    def restarts(self):
        u = jax.random.uniform(jax.random.fold_in(self.key, 0),
                               (self.cfg.lml_restarts, 3), jnp.float32)
        return t32(u, self.device)


class JaxKeyDraws:
    """A draw source for the port's buffer entry points
    (``sample_round_buffers``, ``final_fit_buffers``, ``preview_samples``
    and ``GP_Edge_Tracing.fit_predict_GP``) that replays one JAX key taken
    without a fold, as the reference's ``fit_predict_GP(seed=k)`` takes
    ``PRNGKey(k)`` (models/tracer.py:159, driver.py:719): the sampling
    round splits it (gpr.py:208,233,238), the final fit draws its restart
    uniforms from it (driver.py:590)."""

    def __init__(self, cfg, rank, key, device="cpu"):
        self.cfg, self.rank, self.key, self.device = cfg, rank, key, device

    def sample_normals(self, n):
        k_prior, k_noise = jax.random.split(self.key)
        S = self.cfg.N_samples
        z = jax.random.normal(k_prior, (self.rank, S), jnp.float32)
        w = jax.random.normal(k_noise, (n, S), jnp.float32)
        return t32(z, self.device), t32(w, self.device)

    def restarts(self):
        return t32(jax.random.uniform(self.key, (self.cfg.lml_restarts, 3),
                                      jnp.float32), self.device)


# Fields whose values are selected, not accumulated: equal exactly, as in
# the JAX package's own batch tests (test_parallel.py:103-104).
EXACT = ("edge_trace", "n_iters", "converged", "iter_nobs", "iter_thresh",
         "obs_x", "obs_y", "obs_valid")
# Floats of the loop: the JAX package's tolerance for the same comparison
# (test_parallel.py:134), f32 sums in other orders.
RTOL, ATOL = 1e-4, 2e-3
# The final fit's fields, as (rtol, atol). Its damped-Newton polish stops
# along a flat ridge of the LML (ROADMAP queue 3), and the two packages'
# rounding moves where: from identical training sets, member 2 of
# test_torch_batch.py's ensemble ends 0.076 apart in log σn² and 0.038 in
# log c, at LMLs 0.2% apart (the port's the higher), with mean curves 0.073
# px apart and one column of the integer trace one pixel apart (mean 35.481
# vs 35.516).
FINAL_FIT = {"theta": (0.0, 0.1), "lml": (5e-3, 0.0),
             "y_mean": (0.0, 0.1), "cred_interval": (0.0, 0.1),
             "cred_interval_px": (0.0, 0.15), "y_std": (0.0, 1e-2),
             "final_cost": (1e-3, 0.0)}
# The integer trace is held equal where the reference's mean curve lies
# farther than this from a rounding boundary, and to one pixel elsewhere.
ROUNDING_PX = 0.1

def assert_results_match(got, ref, final_fit=None):
    """The port's batched TraceResult against the reference's: the
    selected fields exactly, the loop's floats at the JAX package's
    tolerance, the final fit's as ``FINAL_FIT`` says, updated by
    ``final_fit``."""
    final_fit = dict(FINAL_FIT, **(final_fit or {}))
    for f in ref._fields:
        r = np.asarray(getattr(ref, f))
        g = np.asarray(getattr(got, f))
        if f == "edge_trace":
            mean = np.asarray(ref.y_mean)
            far = np.abs(mean - np.floor(mean) - 0.5) > ROUNDING_PX
            np.testing.assert_array_equal(g[..., 0][far], r[..., 0][far])
            np.testing.assert_array_equal(g[..., 1], r[..., 1])
            assert np.abs(g[..., 0] - r[..., 0]).max() <= 1
        elif f in EXACT:
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            rtol, atol = final_fit.get(f, (RTOL, ATOL))
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=f)


def assert_same_bits(a, b):
    """Two results of one trace (or of one batch) equal field by field."""
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert x == y, f


# The small slice config: a 64×96 synthetic image, S=256, δx=6.
SMALL_IMG = dict(size=(64, 96), amplitude=40, curvature=2, noise_level=0.03,
                 ltype="sinusoidal", intensity=0.3, gaps=False)
SMALL_KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 20,
                                "length_scale": 8},
                noise_y=1, N_samples=256, score_thresh=1, delta_x=6,
                keep_ratio=0.1, pixel_thresh=4, seed=1, fix_endpoints=True)


# A narrow config that takes the branches of the 1000² S=10⁴ config: S =
# 8192 >= 8192 (K1's transposed copy, best_curves' row take) and 169 bins,
# so n_train = 176 > 160 (the coarse-to-fine final fit and the blocked
# Cholesky and solves).
WIDE_IMG = dict(size=(48, 840), amplitude=30, curvature=1, noise_level=0.03,
                ltype="sinusoidal", intensity=0.3, gaps=False)
WIDE_KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 20,
                               "length_scale": 30},
               noise_y=1, N_samples=8192, score_thresh=1, delta_x=5,
               keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)


# The 1000² S=10⁴ config of ``benchmarks/suite.py`` (config 4), not cut.
BIG_IMG = dict(size=(1000, 1000), amplitude=400, curvature=4,
               noise_level=0.05, ltype="sinusoidal", intensity=0.3, gaps=True)
BIG_KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 200,
                              "length_scale": 50},
              noise_y=1, N_samples=10000, score_thresh=1, delta_x=5,
              keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)


def big_problem(image_seed=1):
    """``(img, edge, grad, init)`` of the 1000² config, built by the JAX
    package as ``benchmarks/suite.py`` builds it (an 11×5 extended Sobel),
    on the image of ``image_seed`` (the suite's is 1)."""
    from gaussian_process_edge_trace_tpu.utils.image import (
        comp_grad_img, kernel_builder)
    from gaussian_process_edge_trace_tpu.utils.synthetic import (
        construct_test_img)
    img, edge = construct_test_img(**dict(BIG_IMG, seed=image_seed))
    grad = np.asarray(comp_grad_img(jnp.asarray(img),
                                    kernel_builder((11, 5), unit=False)),
                      np.float32)
    return img, edge, grad, edge[[0, -1]][:, [1, 0]]


# The JAX package's parallel tests' frames and config (test_parallel.py:
# 38-50 and 61-67): 64² sinusoidal images of seeds 1, 2, ..., S = 64.
PARALLEL_KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 20,
                                   "length_scale": 7},
                   noise_y=1, N_samples=64, score_thresh=0.5, delta_x=5,
                   keep_ratio=0.25, pixel_thresh=4, seed=3,
                   fix_endpoints=True)

# The final cost follows the final fit's mean curve. On the first of these
# frames (image seed 1) the two packages' fits stop 0.046 apart in log σn²
# on the LML's flat ridge (ROADMAP queue 3) from the same accepted pixels,
# at LMLs 1e-3 apart, with mean curves 0.052 px apart (within FINAL_FIT's
# 0.1) and final costs 2.7e-3 apart relative: above FINAL_FIT's 1e-3,
# which one ensemble member set.
PARALLEL_FINAL_FIT = {"final_cost": (5e-3, 0.0)}


def parallel_frames(n_frames, size=(64, 64)):
    """``(grads (F, M, N), inits (F, 2, 2))`` of the JAX package's parallel
    tests' frames, image seeds 1..F, built by the JAX package."""
    from gaussian_process_edge_trace_tpu.utils.image import (
        comp_grad_img, kernel_builder)
    from gaussian_process_edge_trace_tpu.utils.synthetic import (
        construct_test_img)
    grads, inits = [], []
    for f in range(n_frames):
        img, edge = construct_test_img(
            size=size, amplitude=20, curvature=2, noise_level=0.01,
            ltype="sinusoidal", intensity=0.3, gaps=False, seed=f + 1)
        grads.append(np.asarray(comp_grad_img(img, kernel_builder((7, 3))),
                                dtype=np.float32))
        N = size[1]
        inits.append([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    return np.stack(grads), np.asarray(inits)


def small_problem(img_kw=None):
    """``(img, edge, grad, init)`` of the small slice config (or of
    ``img_kw``), built by the JAX package (the port's own image functions
    are tested against it)."""
    from gaussian_process_edge_trace_tpu.utils.image import (
        comp_grad_img, kernel_builder)
    from gaussian_process_edge_trace_tpu.utils.synthetic import (
        construct_test_img)
    img_kw = img_kw or SMALL_IMG
    img, edge = construct_test_img(**img_kw)
    grad = np.asarray(comp_grad_img(img, kernel_builder((9, 5))), np.float32)
    N = img_kw["size"][1]
    init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    return img, edge, grad, init
