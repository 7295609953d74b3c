"""Checkpoint and resume of a trace's state.

Port of ``gaussian_process_edge_trace_tpu/trace/checkpoint.py``. The loop
carry is an explicit :class:`~.driver.TraceState`, so a warm start, a
resume mid-trace and a frame sequence's hand-off are one mechanism:

- :func:`save_checkpoint` / :func:`load_checkpoint` — the state with the
  whole :class:`~.driver.TracerConfig` and a SHA-256 fingerprint of the
  per-image arrays; loading refuses a config or fingerprint that does not
  match what the caller resumes with;
- :func:`save_state` / :func:`load_state` — the state alone;
- :func:`resume_trace` — a saved state run to the end
  (:func:`~.driver.run_trace` takes the loop carry as its input). The
  default draws are keyed by the config's seed and the state's iteration
  alone (:class:`~.driver.StreamDraws`, the JAX package's stream), so a
  resumed trace draws what the uninterrupted one draws, with no generator
  state saved, also from a checkpoint that the JAX package wrote;
- :func:`obs_from_result` — a finished trace's accepted observations as
  (n, 2) xy, the warm start of the next frame (gpet.py:57-61).

The file is the JAX package's ``.npz`` layout: the same keys, and its
dtypes (int32 ``it``, ``n_fobs``, ``obs_*``, ``user_*`` and ``iter_nobs``;
bool masks; float32 floats), so a checkpoint written by either package
loads in either. Loading gives the port's types (int64 tensors, a host
``int`` for ``it``) on the caller's device.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from gaussian_process_edge_trace_torch.models.kernels import KernelSpec
from gaussian_process_edge_trace_torch.trace.driver import (
    TracerConfig, TraceState, run_trace)
from gaussian_process_edge_trace_torch.trace.select import BinSpec

_FIELDS = TraceState._fields
# The JAX package's dtypes of the saved fields; the rest are float32 or
# bool already.
_INT32 = ("obs_x", "obs_y", "user_x", "user_y", "n_fobs", "it", "iter_nobs")


def cfg_to_json(cfg: TracerConfig) -> str:
    """A TracerConfig, with its KernelSpec and BinSpec, as JSON."""
    d = cfg._asdict()
    d["kernel"] = dict(cfg.kernel._asdict())
    d["bins"] = dict(cfg.bins._asdict())
    return json.dumps(d, sort_keys=True)


def cfg_from_json(s: str) -> TracerConfig:
    d = json.loads(s)
    kernel = KernelSpec(**d.pop("kernel"))
    bins = BinSpec(**d.pop("bins"))
    # A field added after a checkpoint was written defaults as the class.
    d.setdefault("reference_quirks", True)
    return TracerConfig(kernel=kernel, bins=bins, **d)


def _host(v, dtype=None):
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)
    return a if dtype is None else a.astype(dtype)


def data_fingerprint(data) -> str:
    """SHA-256 over the arrays that define the trace's inputs: the
    gradient image as float32 and the sorted inits as int32, each with its
    shape and dtype, as the JAX package hashes them (checkpoint.py:56-66),
    so the same image and inits give the same digest in both packages. The
    config covers the rest (prior factor, x grid)."""
    h = hashlib.sha256()
    for f, dtype in (("grad_img", np.float32), ("init_x", np.int32),
                     ("init_y", np.int32)):
        a = np.ascontiguousarray(_host(getattr(data, f), dtype))
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _state_arrays(state: TraceState) -> dict:
    if not isinstance(state.it, int):
        raise ValueError("a checkpoint holds one trace's state")
    return {f: _host(getattr(state, f), np.int32 if f in _INT32 else None)
            for f in _FIELDS}


def _state_from(z, device) -> TraceState:
    fields = {}
    for f in _FIELDS:
        a = z[f]
        if f == "it":
            fields[f] = int(a)
        else:
            t = torch.as_tensor(a, device=device)
            fields[f] = t.to(torch.int64) if f in _INT32 else t
    return TraceState(**fields)


def _device(device, data):
    if device is not None:
        return device
    return data.grad_img.device if data is not None else "cuda"


def save_checkpoint(path, cfg: TracerConfig, state: TraceState,
                    data=None) -> None:
    """Write one trace's state, its config and, with ``data``, the data
    fingerprint (np.savez: ``.npz`` is appended to a path without it)."""
    np.savez(path, __cfg__=np.array(cfg_to_json(cfg)),
             __fingerprint__=np.array(
                 "" if data is None else data_fingerprint(data)),
             **_state_arrays(state))


def load_checkpoint(path, expect_cfg: TracerConfig | None = None,
                    data=None, device=None):
    """``(cfg, state)`` of a checkpoint, refusing one whose config or data
    fingerprint does not match what the caller is about to resume with.

    Args:
      expect_cfg: when given, must equal the saved config exactly.
      data: when given (and the checkpoint recorded a fingerprint), its
        arrays must hash to the saved fingerprint.
      device: where the state goes; by default ``data``'s device, or
        ``"cuda"`` without ``data``.

    Raises:
      ValueError: on a config or fingerprint mismatch.
    """
    with np.load(path) as z:
        cfg = cfg_from_json(str(z["__cfg__"]))
        fp_saved = str(z["__fingerprint__"])
        state = _state_from(z, _device(device, data))
    if expect_cfg is not None and expect_cfg != cfg:
        diffs = [f for f in TracerConfig._fields
                 if getattr(expect_cfg, f) != getattr(cfg, f)]
        raise ValueError(
            f"checkpoint config mismatch (fields {diffs}); refusing to "
            "resume a different trace program")
    if data is not None and fp_saved:
        fp_now = data_fingerprint(data)
        if fp_now != fp_saved:
            raise ValueError(
                "checkpoint data fingerprint mismatch (saved "
                f"{fp_saved[:12]}…, got {fp_now[:12]}…); refusing to "
                "resume on different image/init data")
    return cfg, state


def save_state(path, state: TraceState) -> None:
    """Write one trace's state alone, in the checkpoint's layout."""
    np.savez(path, **_state_arrays(state))


def load_state(path, device="cuda") -> TraceState:
    """A state written by :func:`save_state` (or the JAX package's), on
    ``device``."""
    with np.load(path) as z:
        return _state_from(z, device)


def resume_trace(cfg: TracerConfig, data, state: TraceState, draws=None):
    """A (possibly mid-loop) trace continued to the end: iteration ``it``
    draws ``draws.normals(it)`` as the uninterrupted trace did."""
    return run_trace(cfg, data, state, draws=draws)


def obs_from_result(result):
    """A finished trace's accepted observations, (n, 2) xy int64."""
    valid = _host(result.obs_valid)
    return np.stack([_host(result.obs_x)[valid], _host(result.obs_y)[valid]],
                    axis=1).astype(np.int64)
