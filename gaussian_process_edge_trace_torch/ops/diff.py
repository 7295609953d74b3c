"""Finite differencing (reference: gpet.py:336-367).

Port of ``gaussian_process_edge_trace_tpu/ops/diff.py``: the reference's
loop as one gather-and-subtract with the same index arithmetic. ``typ`` 0 =
forward, 1 = backward, 2 = central; ``h`` is the step. The cost function
uses ``typ=0, h=1`` (gpet.py:400), where every index is in range.
"""

from __future__ import annotations

import torch


def finite_diff(y, typ=0, h=1):
    """Differences of ``y`` (a tensor, or anything ``torch.as_tensor``
    takes) along its first axis: for ``typ`` in {0, 1, 2} the index bounds
    (lower, upper) are [(0, N-1), (1, N), (1, N-1)] and the offsets (b, a)
    [(h, 0), (0, -h), (-h, h)], and ``diff[i - lower] = y[i + b] - y[i +
    a]`` (gpet.py:359-366). Returns ``upper - lower`` values. With ``h >
    1`` an index can leave the array: as in the JAX package's gather, a
    negative one counts from the end and the rest are clamped into it."""
    y = torch.as_tensor(y)
    n = y.shape[0]
    lower, upper = [(0, n - 1), (1, n), (1, n - 1)][typ]
    b, a = [(h, 0), (0, -h), (-h, h)][typ]
    idx = torch.arange(lower, upper, device=y.device)

    def take(off):
        i = idx + off
        return y[torch.clamp(torch.where(i < 0, i + n, i), 0, n - 1)]
    return take(b) - take(a)
