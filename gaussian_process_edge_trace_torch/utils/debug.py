"""Debug configuration: NaN checking and finite validation of results.

Port of ``gaussian_process_edge_trace_tpu/utils/debug.py``. The reference
has no sanitizers (single-threaded NumPy). The JAX package's knob is
``jax_debug_nans``; its counterpart here is :class:`NanCheckMode`, a
``TorchDispatchMode`` that checks the floating outputs of every PyTorch op
and raises ``FloatingPointError`` naming the op that made a NaN. Enable it
globally with :func:`enable_debug` (or ``GPET_DEBUG=1`` in the environment,
honoured when the package is imported), or scoped with :func:`debug_nans`;
:func:`assert_all_finite` validates a whole result after the fact.

Caveats:

- Two paths make NaNs on purpose and sanitise them: K5 (the batched
  Cholesky) writes NaN for a matrix that is not positive definite, and
  ``safe_cholesky``'s jitter escalation discards such candidates; and the
  LML screen's non-PD probes give NaN values that are replaced by +inf
  before ranking. A whole trace under the check therefore stops at those
  intentional intermediates: the knob is for single stages and user-level
  computations, and :func:`assert_all_finite` is the whole-result check.
- The hand-written kernels K1-K6 are launched through ``ctypes``, not
  through PyTorch's dispatcher, so the check does not see their outputs
  when they are written; a NaN they write is caught only where a later
  PyTorch op reads it and passes it on.
- Each checked op reads its outputs back to the host (one synchronise per
  op on the card): a debugging aid, slow by design.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.numel() > 0 and bool(torch.isnan(t).any()))


class NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` when a PyTorch op returns a NaN in a
    floating output (the counterpart of ``jax_debug_nans``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if any(_has_nan(o) for o in outs):
            raise FloatingPointError(f"NaN produced by {func}")
        return out


_global_mode = None


def enable_debug(enabled: bool = True) -> None:
    """Turn the NaN check on (or off) for every op that follows, until
    turned off."""
    global _global_mode
    if enabled and _global_mode is None:
        _global_mode = NanCheckMode()
        _global_mode.__enter__()
    elif not enabled and _global_mode is not None:
        mode, _global_mode = _global_mode, None
        mode.__exit__(None, None, None)


@contextlib.contextmanager
def debug_nans():
    """The NaN check for the block only; the previous setting is restored
    on the way out, also when the check raises."""
    with NanCheckMode():
        yield


def _leaves(tree, path):
    if isinstance(tree, torch.Tensor) or hasattr(tree, "dtype"):
        yield path, tree
    elif hasattr(tree, "_fields"):                  # NamedTuple
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif isinstance(tree, float):
        yield path, tree


def assert_all_finite(tree, name: str = "result") -> None:
    """Check every floating leaf of a result (a ``TraceResult`` or any
    NamedTuple, dict, tuple or list of tensors, arrays and floats) on the
    host; raise ``FloatingPointError`` naming the first field that holds a
    NaN or an infinity. Integer and bool leaves are skipped."""
    import numpy as np

    for path, leaf in _leaves(tree, name):
        if isinstance(leaf, float):
            ok = math.isfinite(leaf)
        elif isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            ok = bool(torch.isfinite(leaf).all())
        else:
            a = np.asarray(leaf)
            if not np.issubdtype(a.dtype, np.floating):
                continue
            ok = bool(np.isfinite(a).all())
        if not ok:
            raise FloatingPointError(f"non-finite values in {path}")
