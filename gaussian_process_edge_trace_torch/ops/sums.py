"""Sums whose order of adds does not depend on the batch.

On the card ``torch.sum`` picks its thread layout, and so the order of its
adds, from the number of sums it takes, so a frame summed in a batch can
round apart from the same frame summed alone. :func:`tree_sum` adds in a
fixed pairwise tree that depends on the length of the summed axis alone;
:func:`fixed_sum` takes it on the card and ``torch.sum`` on the CPU, where
one order per sum already holds and the JAX package's parity is checked.
The final fit (``models/gpr.py``) and the curve cost's Simpson sums
(``ops/integrate.py``, ``ops/cuda_interp.py::line_and_arc``) sum through
them.
"""

from __future__ import annotations

import torch


def _on_card(x):
    return x.device.type == "cuda"


def tree_sum(x, dim=-1):
    """Sum over ``dim`` by a fixed pairwise tree of elementwise adds, the
    axis padded with zeros to a power of two: the order of the adds depends
    on the length of ``dim`` alone, not on the other axes. The halves are
    taken along ``dim`` in place (no copy moves the axis), and the padding
    enters as the adds of zero it stands for."""
    dim = dim % x.dim()
    n = x.shape[dim]
    if n == 0:
        return x.sum(dim)
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        # The tree's first level: entry i of the lower half plus entry
        # i + width/2, which lies past the end (a zero) for i >= n - width/2.
        half = width // 2
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        x = torch.cat([x.narrow(dim, 0, n - half) + x.narrow(dim, half,
                                                             n - half),
                       x.narrow(dim, n - half, width - n) + zero], dim)
    while x.shape[dim] > 1:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    return x.squeeze(dim)


def fixed_sum(x, dim=-1):
    """Sum over ``dim`` in an order that does not depend on the other axes:
    :func:`tree_sum` on the card, where ``torch.sum`` picks its thread
    layout from the number of sums it takes; ``torch.sum`` on the CPU."""
    return tree_sum(x, dim) if _on_card(x) else x.sum(dim)
