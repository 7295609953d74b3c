"""The 1000² config (``benchmarks/suite.py`` config 4, S=10⁴ by default)
traced by the JAX package and by the PyTorch port's CPU path from the same
random draws.

Run from the repository root on a CPU (about 75 s per replayed seed and
20 s per reference-only seed on 8 cores, 2.4 GB of memory at most):

    JAX_PLATFORMS=cpu python tests/torch_reference_1000.py --seeds 1 2 3 \
        --reference-only 4 5 6 7 8 9 10

``--image-seed K [K ...]`` traces the config's images drawn from seeds K
(the suite's is 1; ``chip_smoke.py``'s 1000² batches take 1-4, and 1-16 at
E = 999), each with every tracer seed of the run.
``--samples S`` traces the config at S posterior samples per iteration
(the suite's other rows: 1000 and 100000; at S=10⁵ the JAX package's CPU
KDE scans 76 blocks of 532 MB per iteration, several minutes per seed,
and the replay holds the port's dense CPU binning beside it).
``--right-end 998`` puts the right endpoint at column 998 instead of the
last one, so the edge length E = 999 is odd and both packages score the
curves on their unfused path (column interpolation, then the Simpson sums
with their even-count tails); MSE and DICE are then taken against the true
edge's first 999 columns.

For each seed of ``--seeds`` the reference's loop (``trace_step``) and the
port's (``_iteration``, on the reference's data with the reference's draws
replayed by ``torch_parity.JaxDraws``) run one iteration at a time, then
each package's final fit. One line reports the iterations, the
per-iteration observation counts, whether the accepted pixels are the same,
how many columns of the integer traces differ, the largest gap of the mean
curves, and MSE and DICE against the true edge for both. Where an
iteration first accepts other pixels, the line gives the bins, the largest
gap between the two packages' samples, and whether the port's scoring, KDE
and selection pick the reference's pixels from the reference's samples of
that iteration. For each seed of ``--reference-only`` the reference's
``run_trace`` runs alone. The command exits 1 if a replayed seed differs
other than through its samples. The reference's final fit
takes its batched path, as on the TPU, with XLA's LAPACK Cholesky and
triangular solves in place of the Pallas kernels (as in
``test_torch_slice.py``). The last line is one JSON object of all rows.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.scipy.linalg import solve_triangular  # noqa: E402

import gaussian_process_edge_trace_tpu as rgpt  # noqa: E402
from gaussian_process_edge_trace_torch import interop  # noqa: E402
from gaussian_process_edge_trace_torch.trace import driver as pd  # noqa: E402
from gaussian_process_edge_trace_torch.trace.kde import curve_kde  # noqa: E402
from gaussian_process_edge_trace_torch.trace.scoring import (  # noqa: E402
    best_curves, curve_costs)
from gaussian_process_edge_trace_torch.trace.select import (  # noqa: E402
    select_pixels)
from gaussian_process_edge_trace_tpu.ops import pallas_chol as pc  # noqa: E402
from gaussian_process_edge_trace_tpu.trace import driver as rd  # noqa: E402
from torch_parity import BIG_KW, JaxDraws, big_problem  # noqa: E402


def batched_reference_fit():
    """The reference's TPU final-fit path on XLA's CPU linear algebra."""
    rd.optimize_lml = functools.partial(rd.optimize_lml, use_batched=True)
    pc.cholesky_auto = jnp.linalg.cholesky
    pc.forward_solve_auto = lambda L, R: solve_triangular(L, R, lower=True)
    pc.backward_solve_auto = lambda L, R: solve_triangular(
        L, R, lower=True, trans="T")


def scores(trace, edge):
    return (float(rgpt.trace_MSE(np.asarray(trace), edge)),
            float(rgpt.trace_dicecoef(np.asarray(trace), edge)))


STATE_FIELDS = ("obs_x", "obs_y", "obs_valid", "n_fobs", "score_thresh")


def same_state(pstate, rstate):
    return all(np.array_equal(getattr(pstate, f).cpu().numpy(),
                              np.asarray(getattr(rstate, f)))
               for f in STATE_FIELDS)


def port_selects_from(pcfg, pdata, pprev, samples):
    """The port's scoring, ranking, KDE and selection of one iteration run
    on the given (E, S) samples from the state ``pprev``."""
    samples = torch.as_tensor(np.asarray(samples))
    costs, samples_t = curve_costs(pdata.grad_cols, samples,
                                   kde_thresh=pcfg.kde_thresh,
                                   return_samples_t=True)
    bc, bcosts = best_curves(samples, costs, pcfg.N_keep,
                             samples_t=samples_t)
    inv = 1.0 / bcosts
    kde = curve_kde(bc, inv / inv.sum(), pcfg.M, pcfg.N, pcfg.x_st)
    return select_pixels(
        kde, pdata.grad_kde, torch.cat([pprev.user_x, pprev.obs_x]),
        torch.cat([pprev.user_y, pprev.obs_y]),
        torch.cat([pprev.user_valid, pprev.obs_valid]),
        n_pre=pprev.n_fobs, score_thresh=pprev.score_thresh, spec=pcfg.bins,
        fix_endpoints=pcfg.fix_endpoints, kde_thresh=pcfg.kde_thresh,
        pixel_thresh=pcfg.pixel_thresh, algo_thresh=pcfg.algo_thresh,
        max_decays=pcfg.max_decays)


def lockstep(cfg, data, state0):
    """Both loops, one iteration of each at a time, from the reference's
    draws. At the first iteration whose state differs, the port's scoring
    to selection also runs on the reference's samples of that iteration."""
    pcfg, pdata, pstate = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state0._asdict()), device="cpu")
    draws = JaxDraws(pcfg, pdata.L_prior_unit.shape[1])
    rstate, info = state0, {"first_diff_iter": None}
    while True:
        r_go = (int(rstate.n_fobs) < cfg.algo_thresh
                and int(rstate.it) < cfg.max_iters)
        p_go = (pstate.n_fobs.item() < pcfg.algo_thresh
                and pstate.it < pcfg.max_iters)
        if not (r_go or p_go):
            break
        it, pprev = pstate.it, pstate
        if r_go:
            rstate, rsamples = rd.trace_step(cfg, data, rstate)
        if p_go:
            pstate, psamples = pd.trace_step(pcfg, pdata, pstate, draws)
        if (info["first_diff_iter"] is None and r_go and p_go
                and not same_state(pstate, jax.device_get(rstate))):
            sel = port_selects_from(pcfg, pdata, pprev, rsamples)
            ref = jax.device_get(rstate)
            bins = np.nonzero(pstate.obs_y.numpy()
                              != np.asarray(ref.obs_y))[0]
            info.update(
                first_diff_iter=it, bins_differ=bins.tolist(),
                port_y=pstate.obs_y.numpy()[bins].tolist(),
                ref_y=np.asarray(ref.obs_y)[bins].tolist(),
                samples_max_gap_px=float(np.abs(
                    psamples.numpy() - np.asarray(rsamples)).max()),
                port_on_ref_samples_selects_ref_pixels=same_state(sel, ref))
    res = pd.finish_trace(pcfg, pdata, pstate, draws)
    ref = jax.device_get(rd.finish_trace(cfg, data, rstate))
    return ref, res, info


def run_seed(seed, edge, grad, init, replay, samples):
    edge = edge[:init[1, 0] + 1]
    cfg = rd.make_config(init, grad.shape, **dict(BIG_KW, seed=seed,
                                                  N_samples=samples))
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    row = {"seed": seed}
    t0 = time.perf_counter()
    if replay:
        ref, got, info = lockstep(cfg, data, state0)
    else:
        ref = jax.device_get(rd.run_trace(cfg, data, state0))
    row["seconds"] = round(time.perf_counter() - t0, 1)
    n = int(ref.n_iters)
    row["ref_iters"] = n
    row["ref_iter_nobs"] = np.asarray(ref.iter_nobs)[:n].tolist()
    row["ref_mse"], row["ref_dice"] = scores(ref.edge_trace, edge)
    if replay:
        row["port_iters"] = got.n_iters
        row["same_pixels"] = got.n_iters == n and all(
            np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
            for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"))
        row.update(info)
        dy = got.edge_trace.numpy()[:, 0] != np.asarray(ref.edge_trace)[:, 0]
        row["trace_cols_differ"] = int(dy.sum())
        row["mean_max_gap_px"] = float(np.abs(
            got.y_mean.numpy() - np.asarray(ref.y_mean)).max())
        row["port_mse"], row["port_dice"] = scores(got.edge_trace.numpy(),
                                                   edge)
        row["lml"] = [float(got.lml), float(ref.lml)]
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3])
    p.add_argument("--reference-only", type=int, nargs="*", default=[])
    p.add_argument("--right-end", type=int, default=999,
                   help="column of the right endpoint (999: the last)")
    p.add_argument("--image-seed", type=int, nargs="+", default=[1],
                   help="seeds of the synthetic images (1: the suite's); "
                        "every seed is traced on each image in turn")
    p.add_argument("--samples", type=int, default=BIG_KW["N_samples"],
                   help="posterior samples per iteration (the suite's rows: "
                        "1000, 10000, 100000)")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    batched_reference_fit()
    rows = []
    for image_seed in args.image_seed:
        _, edge, grad, init = big_problem(image_seed)
        init = edge[[0, args.right_end]][:, [1, 0]]
        for seed, replay in ([(s, True) for s in args.seeds]
                             + [(s, False) for s in args.reference_only]):
            row = run_seed(seed, edge, grad, init, replay, args.samples)
            row["edge_length"] = int(init[1, 0]) + 1
            row["samples"] = args.samples
            row["image_seed"] = image_seed
            print(json.dumps(row), flush=True)
            rows.append(row)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**10
    print(json.dumps({"rows": rows, "peak_rss_mib": round(peak, 1)}))
    return 0 if all(r.get("same_pixels", True)
                    or r["port_on_ref_samples_selects_ref_pixels"]
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
