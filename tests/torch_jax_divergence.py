"""Where the port's trace parts from the JAX package's, stage by stage.

From the JAX package's state before iteration IT of one of
tests/torch_jax_fixtures.py's traces (default: 1000_S1e4 seed 2, iteration
12, where the two first accept other pixels), both packages take the
iteration on the CPU with the same draws, and the script prints as one JSON
line how far apart their samples, costs, kept sets, KDE maps and score maps
lie, the costs at the N_keep cut, and how far the JAX package's own score
map moves at its accepted pixels when only the two curves at its cut swap::

    JAX_PLATFORMS=cpu python3 tests/torch_jax_divergence.py 1000_S1e4 2 12
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_jax_fixtures as fx  # noqa: E402
from gaussian_process_edge_trace_torch import interop  # noqa: E402
from gaussian_process_edge_trace_torch.trace import driver as pd  # noqa: E402
from gaussian_process_edge_trace_tpu.trace import driver as rd  # noqa: E402
from gaussian_process_edge_trace_tpu.trace.kde import (  # noqa: E402
    blur_matrices, curve_kde)
from gaussian_process_edge_trace_tpu.trace.scoring import (  # noqa: E402
    curve_costs)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def probe(name, seed, it):
    spec, right = {n: (s, r) for n, s, r, _ in fx.TRACES}[name]
    grad, init, _ = fx.problem(spec, right)
    cfg_data = fx._tracer(spec, grad, init, seed)
    cfg, data = cfg_data.cfg, cfg_data.data
    step = jax.jit(functools.partial(rd.trace_step, cfg))
    state = rd.init_state(cfg)
    for _ in range(it):
        state, _ = step(data, state)
    new, samples = step(data, state)
    even = "avg" if cfg.legacy_simpson else "simpson"
    blur = blur_matrices(cfg.M, cfg.N, data.grad_kde.dtype)

    def score_of(samples, order):
        kept = order[:cfg.N_keep]
        bc, bcosts = samples[:, kept], costs_j[kept]
        inv = 1.0 / bcosts
        kde = np.asarray(curve_kde(jnp.asarray(bc),
                                   jnp.asarray(inv / inv.sum()), cfg.M,
                                   cfg.N, cfg.x_st, blur=blur))
        g = np.asarray(data.grad_kde)
        return kde, (kde * g + kde + g) / 3.0

    samples = np.asarray(samples)
    costs_j = np.asarray(curve_costs(
        data.grad_img, data.x_grid, jnp.asarray(samples),
        kde_thresh=cfg.kde_thresh, cols=data.grad_cols, even=even))
    order_j = np.argsort(costs_j, kind="stable")
    kde_j, score_j = score_of(samples, order_j)
    swapped = order_j.copy()
    swapped[[cfg.N_keep - 1, cfg.N_keep]] = swapped[[cfg.N_keep,
                                                     cfg.N_keep - 1]]
    _, score_swap = score_of(samples, swapped)

    pcfg, pdata, pstate = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(state._asdict()), device="cpu")
    draws = pd.StreamDraws(pcfg, pdata.L_prior_unit.shape[1],
                           torch.device("cpu"))
    _, psamples, pscore, pkde = pd._iteration(
        pcfg, pdata, pd._lift(pstate), draws, it,
        pd.loop_invariants(pcfg, pdata), with_score=True)
    psamples, pscore, pkde = psamples[0], pscore[0], pkde[0]
    from gaussian_process_edge_trace_torch.trace.scoring import (
        curve_costs as port_costs)
    costs_p = port_costs(pdata.grad_cols, psamples[None],
                         kde_thresh=pcfg.kde_thresh, even=even)[0].numpy()
    order_p = np.argsort(costs_p, kind="stable")
    nx, ny, nv = (np.asarray(a) for a in (new.obs_x, new.obs_y,
                                          new.obs_valid))
    at = [(ny[b], nx[b]) for b in range(len(nx)) if nv[b]]

    def at_pixels(a, b):
        return max(abs(float(a[p]) - float(b[p])) / abs(float(b[p]))
                   for p in at)
    cut = slice(cfg.N_keep - 1, cfg.N_keep + 1)
    return {
        "trace": f"{name}/{seed}", "iteration": it, "N_keep": cfg.N_keep,
        "samples_rel": _rel(psamples.numpy(), samples),
        "costs_max_rel": float(np.max(np.abs(costs_p - costs_j)
                                      / np.abs(costs_j))),
        "kept_sets_differ_in": len(set(order_j[:cfg.N_keep])
                                   ^ set(order_p[:cfg.N_keep])),
        "jax_costs_at_cut": costs_j[order_j[cut]].tolist(),
        "port_costs_at_cut": costs_p[order_p[cut]].tolist(),
        "kde_rel": _rel(pkde.numpy(), kde_j),
        "score_rel": _rel(pscore.numpy(), score_j),
        "port_vs_jax_at_jax_pixels": at_pixels(pscore.numpy(), score_j),
        "jax_cut_swapped_at_jax_pixels": at_pixels(score_swap, score_j)}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    a = sys.argv[1:]
    print(json.dumps(probe(a[0] if a else "1000_S1e4",
                           int(a[1]) if len(a) > 1 else 2,
                           int(a[2]) if len(a) > 2 else 12)))
