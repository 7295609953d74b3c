"""The comparison that decides ``correct``: what the timed path produced
for a trace, held against the plain reference (``reference.py``).

Each compared trace gives these numbers; a run's number is the largest
over its compared traces, and ``parted_share`` the share of them:

- ``curve_gap_px``: the first iteration's optimal curve against the
  nearest of the reference's ``FIRST_KEPT`` cheapest curves of that
  iteration (a near-tie for the cheapest may order them apart), the
  largest pixel gap over the curve. The first iteration starts from the
  same state on both sides, whatever the loop does later. It holds the
  draws (K7), the sampling round and the ranking.
- ``cost_gap_rel``: the program's cost of that curve against the
  reference's cost of the matched curve, and its final cost against the
  reference's cost of its final mean curve, relative. It holds the curve
  costs (K1, or K2 with ``line_and_arc``).
- ``parted_share``: the share of compared traces whose loop parts from the
  reference's: an iteration whose accepted-pixel count or threshold
  differs, or another iteration count. It holds every iteration's stages
  together, the KDE (K3) and the selection above all, which decide the
  accepted pixels.
- ``mean_gap_px``: the program's posterior mean against the reference's
  fit at the program's θ on the program's final observations (its own
  state, so a parting in the loop does not reach it): K5/K6's factors and
  solves.
- ``lml_short``: how far the program's θ falls short of the reference's
  own LML search (screen, polish and, above 160 slots, the coarse-to-fine
  pass) on the program's final observations: the reference's log marginal
  likelihood at its θ less that at the program's θ, both in float64. It
  holds the program's LML search (K5/K6 inside its LML evaluations). The
  float32 LML has several optima within a few hundredths of each other, at
  means up to tens of pixels apart, and the two searches may stop at
  different ones: the mean at the reference's θ cannot be compared, its
  likelihood can.
- ``interval_gap``: the credible interval delivered to the host against
  the reference's mean ∓ 1.96·std at the program's θ.
- ``edge_off``: columns of the delivered integer trace that are not the
  reference's rounded mean, away from a rounding tie (the fractional part
  within 0.01 of one half), or whose x is not the grid's. Exact: limit 0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gpet_bench import reference as refmod

NUMBERS = ("curve_gap_px", "cost_gap_rel", "parted_share", "mean_gap_px",
           "lml_short", "interval_gap", "edge_off")
TIE = 0.01


class Output(NamedTuple):
    """What one trace delivered, and the internals that the check reads:
    the program's :class:`TraceResult` fields, or the control's."""
    n_iters: int
    iter_curves: torch.Tensor
    iter_costs: torch.Tensor
    iter_nobs: list
    iter_thresh: list
    obs_x: torch.Tensor
    obs_y: torch.Tensor
    obs_valid: torch.Tensor
    theta: torch.Tensor
    y_mean: torch.Tensor
    final_cost: float
    edge: np.ndarray       # (E, 2) yx, as delivered
    cred: np.ndarray       # (2, E), as delivered


def from_result(res, edge, cred) -> Output:
    """An :class:`Output` of one trace's ``TraceResult`` (the program's
    own type, read by its field names) and the host arrays delivered."""
    n = int(res.n_iters)
    return Output(n_iters=n, iter_curves=res.iter_curves[:n],
                  iter_costs=res.iter_costs[:n],
                  iter_nobs=[int(v) for v in res.iter_nobs[:n].tolist()],
                  iter_thresh=[float(v) for v in
                               res.iter_thresh[:n].tolist()],
                  obs_x=res.obs_x, obs_y=res.obs_y, obs_valid=res.obs_valid,
                  theta=res.theta, y_mean=res.y_mean,
                  final_cost=float(res.final_cost), edge=np.asarray(edge),
                  cred=np.asarray(cred))


def control_output(ref_tf32: refmod.Reference, seed) -> Output:
    """The control in the program's place: the reference at TF32."""
    t = ref_tf32.run(seed)
    d = ref_tf32.d
    cost = float(refmod.curve_costs(d.cols, t.y_mean[:, None])[0])
    cred = torch.stack([t.y_mean - 1.96 * t.y_std, t.y_mean + 1.96 * t.y_std])
    return Output(n_iters=t.n_iters, iter_curves=t.iter_curves,
                  iter_costs=t.iter_costs, iter_nobs=t.iter_nobs,
                  iter_thresh=t.iter_thresh, obs_x=t.obs_x, obs_y=t.obs_y,
                  obs_valid=t.obs_valid, theta=t.theta,
                  y_mean=t.y_mean, final_cost=cost,
                  edge=t.edge_trace.cpu().numpy(), cred=cred.cpu().numpy())


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def lml64(p: refmod.Plan, f: refmod.Fit, theta) -> float:
    """The reference's log marginal likelihood of θ on the fit inputs
    ``f``, in float64."""
    return float(refmod.batched_lml(
        p, f.xs.double(), f.ys.double(), f.mask, theta.double()[None],
        f.noise_w.double(), False, lambda a, b: a @ b)[0])


def compare(ref: refmod.Reference, out: Output, seed) -> dict:
    """The numbers of one trace: ``out`` against the reference's run of
    the same inputs and seed (the loop) and against the reference's fit on
    ``out``'s own final observations (the final fit at ``out``'s θ, and
    the likelihood of that θ against the reference's own search's)."""
    p, d = ref.p, ref.d
    t = ref.run(seed)
    n = min(out.n_iters, t.n_iters)
    part = n
    for k in range(n):
        if (out.iter_nobs[k] != t.iter_nobs[k]
                or np.float32(out.iter_thresh[k]) != np.float32(
                    t.iter_thresh[k])):
            part = k
            break
    parted = part < n or out.n_iters != t.n_iters
    curve_gap, cost_gap = math.inf, math.inf
    if n:
        gaps = (t.first_curves - out.iter_curves[0][:, None].to(
            t.first_curves)).abs().amax(0)
        j = int(torch.argmin(gaps))
        curve_gap = float(gaps[j])
        cost_gap = _rel(out.iter_costs[0], t.first_costs[j])
    y_out = out.y_mean.to(d.x_grid.device, torch.float32)
    final_ref = float(refmod.curve_costs(d.cols, y_out[:, None])[0])
    cost_gap = max(cost_gap, _rel(out.final_cost, final_ref))

    f = ref.final_fit(out.obs_x.to(d.x_grid.device),
                      out.obs_y.to(d.x_grid.device),
                      out.obs_valid.to(d.x_grid.device), seed)
    theta = out.theta.to(d.x_grid.device, torch.float32)
    y_ref, s_ref = refmod.predict(p, d, f, theta, ref.mm)
    mean_gap = float((y_out - y_ref).abs().max())
    # The reference's own θ on these observations: its run's where the
    # observations are its own, bit for bit (the same fit inputs).
    same = all(torch.equal(a.to(b.device, b.dtype), b) for a, b in (
        (out.obs_x, t.obs_x), (out.obs_y, t.obs_y),
        (out.obs_valid, t.obs_valid)))
    theta_ref = t.theta if same else refmod.optimize_lml(p, f, ref.mm)[0]
    lml_short = lml64(p, f, theta_ref) - lml64(p, f, theta)
    lo, hi = y_ref - 1.96 * s_ref, y_ref + 1.96 * s_ref
    cred = torch.as_tensor(out.cred, dtype=torch.float32,
                           device=y_ref.device)
    interval_gap = float(torch.maximum((cred[0] - lo).abs().max(),
                                       (cred[1] - hi).abs().max()))
    yr = y_ref.double().cpu().numpy()
    tie = np.abs(yr - np.floor(yr) - 0.5) < TIE
    edge = np.asarray(out.edge)
    off = p.E
    if edge.shape == (p.E, 2):
        off = ((edge[:, 0] != np.round(yr)) & ~tie).sum() + (
            edge[:, 1] != d.x_grid.cpu().numpy()).sum()
    nums = {"curve_gap_px": curve_gap, "cost_gap_rel": cost_gap,
            "parted_share": float(parted), "mean_gap_px": mean_gap,
            "lml_short": lml_short, "interval_gap": interval_gap,
            "edge_off": int(off)}
    return {k: (v if np.isfinite(v) else math.inf) for k, v in nums.items()}


def combine(per_trace: list) -> dict:
    """A run's numbers from its traces': the largest of each, and the share
    of traces that parted."""
    out = {}
    for k in NUMBERS:
        vals = [t[k] for t in per_trace]
        out[k] = (float(np.mean(vals)) if k == "parted_share"
                  else max(vals))
    return out


def judge(numbers: dict, limits: dict) -> bool:
    """True where every number is within its limit (a NaN never is)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
