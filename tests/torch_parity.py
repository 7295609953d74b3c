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

    def normals(self, it):
        k_prior, k_noise = jax.random.split(
            jax.random.fold_in(self.key, it + 1))
        S = self.cfg.N_samples
        z = jax.random.normal(k_prior, (self.rank, S), jnp.float32)
        w = jax.random.normal(k_noise, (self.cfg.n_train, S), jnp.float32)
        return t32(z, self.device), t32(w, self.device)

    def restarts(self):
        u = jax.random.uniform(jax.random.fold_in(self.key, 0),
                               (self.cfg.lml_restarts, 3), jnp.float32)
        return t32(u, self.device)


# The small slice config: a 64×96 synthetic image, S=256, δx=6.
SMALL_IMG = dict(size=(64, 96), amplitude=40, curvature=2, noise_level=0.03,
                 ltype="sinusoidal", intensity=0.3, gaps=False)
SMALL_KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 20,
                                "length_scale": 8},
                noise_y=1, N_samples=256, score_thresh=1, delta_x=6,
                keep_ratio=0.1, pixel_thresh=4, seed=1, fix_endpoints=True)


def small_problem():
    """``(img, edge, grad, init)`` of the small slice config, built by the
    JAX package (the port's own image functions are tested against it)."""
    from gaussian_process_edge_trace_tpu.utils.image import (
        comp_grad_img, kernel_builder)
    from gaussian_process_edge_trace_tpu.utils.synthetic import (
        construct_test_img)
    img, edge = construct_test_img(**SMALL_IMG)
    grad = np.asarray(comp_grad_img(img, kernel_builder((9, 5))), np.float32)
    N = SMALL_IMG["size"][1]
    init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    return img, edge, grad, init
