"""Trace-quality metrics (reference: gpet_utils.py:256-313): column-wise MSE
and the DICE coefficient over binarised under-edge masks.

Port of ``gaussian_process_edge_trace_tpu/utils/metrics.py``. The metrics
are host-side bookkeeping: they run on the CPU in float64 and return Python
floats, rounded as the reference rounds them.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_2d(edge):
    if isinstance(edge, torch.Tensor):
        edge = edge.detach().cpu().numpy()
    edge = np.asarray(edge)
    return edge.reshape(-1, 1) if edge.ndim == 1 else edge


def trace_MSE(edge_pred, edge_true):
    """Column-wise mean squared error of the y-coordinates
    (gpet_utils.py:256-269), rounded to 4 decimals."""
    p = torch.as_tensor(_as_2d(edge_pred)[:, 0], dtype=torch.float64)
    t = torch.as_tensor(_as_2d(edge_true)[:, 0], dtype=torch.float64)
    N = p.shape[0]
    return float(torch.round((1.0 / N) * ((p - t) ** 2).sum(), decimals=4))


def trace_dicecoef(edge_pred, edge_true, jaccard=False):
    """DICE (or Jaccard) coefficient over binarised under-edge masks
    (gpet_utils.py:288-313), rounded to 4 decimals. The reference fills
    ``pred_bin[int(y):, col] = 1``; Python slicing wraps a negative start,
    which is reproduced for escaped traces."""
    pred = _as_2d(edge_pred)
    true = _as_2d(edge_true)
    N = pred.shape[0]
    rows = torch.arange(N)[:, None]

    def binarise(y):
        y = torch.as_tensor(y).to(torch.int64)
        start = torch.where(y < 0, torch.clamp(N + y, min=0), y)
        return (rows >= start[None, :]).to(torch.float64)

    pred_bin = binarise(pred[:, 0])
    true_bin = binarise(true[:, 0])
    inter = (pred_bin * true_bin).sum()
    union = torch.clamp(pred_bin + true_bin, 0, 1).sum()
    jacc = inter / union
    if jaccard:
        return float(torch.round(jacc, decimals=4))
    return float(torch.round(2 * jacc / (jacc + 1), decimals=4))
