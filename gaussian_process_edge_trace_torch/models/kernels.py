"""GP covariance functions: RBF and Matérn ν ∈ {1.5, 2.5}, with constant
scaling and a heteroscedastic diagonal.

Port of ``gaussian_process_edge_trace_tpu/models/kernels.py``. Kernels are
functions of 1-D pixel-column inputs; padded (masked) observations give an
identity block that decouples exactly under Cholesky.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)


class KernelSpec(NamedTuple):
    """Static kernel configuration."""
    kind: str          # "RBF" or "Matern"
    nu: float = 2.5    # only used for Matern; 1.5 or 2.5


def k_unit(spec: KernelSpec, d):
    """Unit-variance kernel value at scaled distance ``d = |x - x'| / ℓ``."""
    if spec.kind == "RBF":
        return torch.exp(-0.5 * d * d)
    if spec.kind == "Matern":
        if spec.nu == 1.5:
            s = SQRT3 * d
            return (1.0 + s) * torch.exp(-s)
        if spec.nu == 2.5:
            s = SQRT5 * d
            return (1.0 + s + s * s / 3.0) * torch.exp(-s)
        raise NotImplementedError(
            f"Matern nu={spec.nu} (the reference only uses 1.5/2.5)")
    raise NotImplementedError(spec.kind)


def dk_unit_dlog_ls(spec: KernelSpec, d):
    """∂k_unit/∂log ℓ through the scaled distance: −d·k'(d)."""
    if spec.kind == "RBF":
        return d * d * torch.exp(-0.5 * d * d)
    if spec.kind == "Matern":
        if spec.nu == 1.5:
            s = SQRT3 * d
            return s * s * torch.exp(-s)
        if spec.nu == 2.5:
            s = SQRT5 * d
            return (s * s / 3.0) * (1.0 + s) * torch.exp(-s)
        raise NotImplementedError(spec.nu)
    raise NotImplementedError(spec.kind)


def k_unit_np(spec: KernelSpec, d):
    """NumPy mirror of :func:`k_unit` for host-side precomputation."""
    if spec.kind == "RBF":
        return np.exp(-0.5 * d * d)
    s = (SQRT5 if spec.nu == 2.5 else SQRT3) * d
    if spec.nu == 2.5:
        return (1.0 + s + s * s / 3.0) * np.exp(-s)
    return (1.0 + s) * np.exp(-s)


def cross_gram(spec: KernelSpec, x1, x2, length_scale, variance=1.0):
    """K[i, j] = variance · k_unit(|x1[i] − x2[j]| / length_scale)."""
    d = torch.abs(x1[:, None] - x2[None, :]) / length_scale
    return variance * k_unit(spec, d)


def train_gram(spec: KernelSpec, x, length_scale, variance, diag_noise,
               mask=None, pad_diag=1.0):
    """Training Gram ``variance·k_unit + diag(diag_noise)``. With ``mask``,
    padded rows and columns are zeroed and their diagonal set to
    ``pad_diag``: the Gram is block-diagonal ``[[K_valid, 0], [0, I]]``."""
    K = cross_gram(spec, x, x, length_scale, variance)
    n = x.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    K = K + torch.diag(diag_noise)
    if mask is not None:
        m2 = mask[:, None] & mask[None, :]
        zero = torch.zeros((), dtype=K.dtype, device=K.device)
        K = (torch.where(m2, K, zero)
             + torch.where(mask[:, None], zero, pad_diag * eye))
    return K


def resolve_kernel_options(kernel_options, M, edge_length):
    """Resolve the reference's kernel spec (gpet.py:130-151): a dict with
    explicit hyperparameters, or the 3-tuple ``(k, s, l)`` that maps small
    ints to image-relative scales. Returns ``(KernelSpec, σf, ℓ)``."""
    if isinstance(kernel_options, dict):
        sigma_f = kernel_options["sigma_f"]
        sigma_l = kernel_options["length_scale"]
        kernel_type = kernel_options["kernel"]
        # A Matern dict without 'nu' raises KeyError, as the reference does.
        nu = kernel_options["nu"] if kernel_type == "Matern" else 2.5
    else:
        rbf_matern, sigmaf_opt, sigmal_opt = kernel_options
        kernel_type = ["RBF", "Matern"][int(rbf_matern > 0)]
        nu = [2.5, 1.5][int(rbf_matern > 1)]
        sigma_f_const = ([10, 8, 6, 4, 2, 1][sigmaf_opt - 1]
                         if 0 <= sigmaf_opt <= 5 else 1)
        sigma_f = M // sigma_f_const
        sigma_l_const = ([1, 4 / 3, 2, 4, 10][sigmal_opt - 1]
                         if 0 <= sigmal_opt <= 4 else 10)
        sigma_l = edge_length // sigma_l_const
    return (KernelSpec(kind=kernel_type, nu=float(nu)), float(sigma_f),
            float(sigma_l))
