"""Carry a trace's state across from the JAX package.

:func:`from_reference` builds the port's :class:`TracerConfig`,
:class:`TracerData` and :class:`TraceState` from the JAX package's objects,
given as plain Python scalars and numpy arrays — the caller does
``cfg._asdict()`` and ``jax.device_get(data._asdict())``. This system has no
weights: the prior factor, the gradient image, its KDE and columns, and the
loop state take their place. This module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussian_process_edge_trace_torch.models.kernels import KernelSpec
from gaussian_process_edge_trace_torch.trace.driver import (
    TraceState, TracerConfig, TracerData)
from gaussian_process_edge_trace_torch.trace.select import BinSpec


def _fields(v):
    return v._asdict() if hasattr(v, "_asdict") else dict(v)


def _tensor(a, device):
    a = np.array(a)          # a writable copy
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float32), device=device)


def from_reference(cfg_fields, data_arrays, state_arrays=None,
                   device="cpu"):
    """``(cfg, data, state)`` of the port from the reference's
    ``TracerConfig``/``TracerData``/``TraceState`` fields. ``state`` is
    ``None`` when ``state_arrays`` is. Integer arrays become int64, floats
    float32, on ``device``."""
    f = dict(cfg_fields)
    f["kernel"] = KernelSpec(**_fields(f["kernel"]))
    f["bins"] = BinSpec(**_fields(f["bins"]))
    cfg = TracerConfig(**{k: f[k] for k in TracerConfig._fields if k in f})
    data = TracerData(**{k: _tensor(data_arrays[k], device)
                         for k in TracerData._fields})
    if state_arrays is None:
        return cfg, data, None
    s = {k: (int(np.asarray(v)) if k == "it" else _tensor(v, device))
         for k, v in state_arrays.items() if k in TraceState._fields}
    return cfg, data, TraceState(**s)
