"""Write the two fixtures of the JAX package's own numbers that
``chip_smoke.py`` holds the port to on the card, where no JAX runs.

Run from the repository root on a CPU:

    JAX_PLATFORMS=cpu python tests/torch_jax_fixtures.py stream
    JAX_PLATFORMS=cpu python tests/torch_jax_fixtures.py trajectory

``stream`` (a few seconds) writes ``tests/jax_stream_fixture.json``: draws
of ``jax.random`` from keys of seeds 0, 1, 2, 2³¹−1, 2³²+5 and −1, keyed
with ``jax_enable_x64`` off as the JAX package runs (the fixture records
the mode; seeds outside [0, 2³²) key otherwise with it on), through the
JAX package's derivations (iteration keys ``split(fold_in(PRNGKey(s), it +
1))``, the restarts of ``fold_in(PRNGKey(s), 0)``, unfolded keys, ensemble
members ``PRNGKey(s + k)``) at the (r, S) and (n_train, S) shapes of the
demo config, the 1000² config at S = 10⁴ and at S = 10⁵. Each entry holds
the key, the shape, the first and last 8 values as uint32 bit patterns, and
a checksum of the whole draw's bits (:func:`checksum`).

``trajectory`` (about 2 minutes, 2.5 GB) writes
``tests/jax_trajectory_fixture.json``: the JAX package's traces of the
demo config (seeds 1-3), the 1000² S=10⁴ config (seeds 1-3) and the same
with the right endpoint at column 998 (E = 999, seed 1), built as
``chip_smoke.py`` builds them, stepped one ``trace_step`` at a time and
finished with the final fit on its batched path (as
``tests/torch_reference_1000.py`` runs it). Each trace holds n_iters,
iter_nobs, the threshold after each iteration, the pixels each iteration
accepted (per bin, as ``[bin, x, y]``, ``x = -1`` where a bin lost its
pixel), the JAX package's score of every bin's pixel after each iteration
(recomputed from the iteration's samples; null where a bin is empty; the
scale of the two packages' score disagreement at a divergence), the
integer trace, the columns
whose mean lies within ``ROUNDING_PX`` of a rounding boundary, θ, the LML,
the final cost, MSE and DICE against the true edge.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_enable_x64", True)

STREAM_PATH = os.path.join(HERE, "jax_stream_fixture.json")
TRAJECTORY_PATH = os.path.join(HERE, "jax_trajectory_fixture.json")
STREAM_SEEDS = (0, 1, 2, 2 ** 31 - 1, 2 ** 32 + 5, -1)
ROUNDING_PX = 0.1
EDGE = 8

DEMO = dict(size=(500, 500), amplitude=200, ko={"kernel": "RBF",
                                                "sigma_f": 75,
                                                "length_scale": 20},
            n_samples=1000)
BIG = dict(size=(1000, 1000), amplitude=400, ko={"kernel": "RBF",
                                                 "sigma_f": 200,
                                                 "length_scale": 50},
           n_samples=10000)
TRACES = (("demo", DEMO, -1, (1, 2, 3)), ("1000_S1e4", BIG, -1, (1, 2, 3)),
          ("1000_S1e4_oddE", BIG, -2, (1,)))


def checksum(bits) -> int:
    """Σ bits[i]·(i mod 65521 + 1) over the flat uint32 bits, mod 2⁶⁴:
    order-sensitive, and computed on the card as an int64 sum that wraps."""
    b = np.asarray(bits, np.uint32).reshape(-1).astype(np.uint64)
    w = (np.arange(b.size, dtype=np.uint64) % np.uint64(65521)) + np.uint64(1)
    return int(np.sum(b * w, dtype=np.uint64))


def problem(spec, right):
    """``(grad, init, truth)`` of the JAX package, built as
    ``chip_smoke.py::Config`` builds its image."""
    import gaussian_process_edge_trace_tpu as rgpt
    img, edge = rgpt.construct_test_img(spec["size"], spec["amplitude"], 4,
                                        0.05, "sinusoidal", 0.3, gaps=True,
                                        seed=1)
    grad = np.asarray(rgpt.comp_grad_img(
        jnp.asarray(img), rgpt.kernel_builder((11, 5), unit=False)),
        np.float32)
    init = edge[[0, right]][:, [1, 0]]
    E = int(init[1, 0] - init[0, 0]) + 1
    return grad, init, edge[:E]


def _tracer(spec, grad, init, seed):
    from gaussian_process_edge_trace_tpu.models.tracer import GP_Edge_Tracing
    return GP_Edge_Tracing(init, grad, spec["ko"], 1, np.array([]),
                           spec["n_samples"], 1, 5, 0.1, 5, seed, True, True)


def _entry(kind, seed, key, shape, draw, **extra):
    bits = np.asarray(draw).view(np.uint32).reshape(-1)
    return dict(kind=kind, seed=seed, key=[int(k) for k in np.asarray(key)],
                shape=list(shape), head=bits[:EDGE].tolist(),
                tail=bits[-EDGE:].tolist(), checksum=checksum(bits), **extra)


def stream():
    """The stream fixture, every key made with x64 off."""
    with jax.enable_x64(False):
        _stream()


def _stream():
    from gaussian_process_edge_trace_tpu.trace import driver as rd
    shapes = {}
    for name, spec, right in (("demo", DEMO, -1), ("1000_S1e4", BIG, -1),
                              ("1000_S1e5", dict(BIG, n_samples=100000),
                               -1)):
        grad, init, _ = problem(spec, right)
        cfg = rd.make_config(init, grad.shape, spec["ko"], 1, 0,
                             spec["n_samples"], 1, 5, 0.1, 5, 1, True)
        r = rd.prior_factor(cfg)[0].shape[1]
        shapes[name] = dict(r=r, n_train=cfg.n_train, S=cfg.N_samples,
                            lml_restarts=cfg.lml_restarts)
    out = []

    def iteration(seed, it, shp, base=None):
        base = jax.random.PRNGKey(seed) if base is None else base
        kp, kn = jax.random.split(jax.random.fold_in(base, it + 1))
        for part, k, rows in (("prior", kp, shp["r"]),
                              ("noise", kn, shp["n_train"])):
            z = jax.random.normal(k, (rows, shp["S"]), jnp.float32)
            out.append(_entry("iteration", seed, k, (rows, shp["S"]), z,
                              it=it, part=part))

    demo = shapes["demo"]
    for seed in STREAM_SEEDS:
        iteration(seed, 0, demo)
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
        u = jax.random.uniform(k, (demo["lml_restarts"], 3), jnp.float32)
        out.append(_entry("restarts", seed, k, u.shape, u))
    iteration(1, 15, demo)
    for seed in (1, 2 ** 32 + 5):
        iteration(seed, 3, shapes["1000_S1e4"])
    iteration(1, 0, shapes["1000_S1e5"])
    for seed in (0, 3):
        base = jax.random.PRNGKey(seed)
        kp, kn = jax.random.split(base)
        for part, k, rows in (("prior", kp, demo["r"]),
                              ("noise", kn, demo["n_train"])):
            z = jax.random.normal(k, (rows, demo["S"]), jnp.float32)
            out.append(_entry("unfolded", seed, k, (rows, demo["S"]), z,
                              part=part))
        u = jax.random.uniform(base, (demo["lml_restarts"], 3), jnp.float32)
        out.append(_entry("unfolded_restarts", seed, base, u.shape, u))
    for k in (1, 4):
        iteration(1 + k, 0, demo)
        out[-1]["member"] = out[-2]["member"] = k
    bits = jax.random.bits(jax.random.PRNGKey(2), (96, 1000), jnp.uint32)
    out.append(_entry("bits", 2, jax.random.PRNGKey(2), bits.shape, bits))
    with open(STREAM_PATH, "w") as f:
        json.dump({"jax": jax.__version__,
                   "x64": bool(jax.config.jax_enable_x64),
                   "threefry_partitionable":
                   bool(jax.config.jax_threefry_partitionable),
                   "shapes": shapes, "edge": EDGE, "entries": out}, f,
                  separators=(",", ":"))
    print(f"{len(out)} entries -> {STREAM_PATH} "
          f"({os.path.getsize(STREAM_PATH)} bytes)")


def _score_map(cfg, data, samples):
    """The JAX package's pixel scores of one iteration from its samples
    (driver.py:400-440, select.py:130)."""
    from gaussian_process_edge_trace_tpu.trace.kde import (
        blur_matrices, curve_kde)
    from gaussian_process_edge_trace_tpu.trace.scoring import (
        best_curves, curve_costs)
    costs, samples_t = curve_costs(
        data.grad_img, data.x_grid, samples, kde_thresh=cfg.kde_thresh,
        cols=data.grad_cols, even="avg" if cfg.legacy_simpson else "simpson",
        return_samples_t=True)
    bc, bcosts = best_curves(samples, costs, cfg.N_keep, samples_t=samples_t)
    inv = 1.0 / bcosts
    kde = curve_kde(bc, inv / jnp.sum(inv), cfg.M, cfg.N, cfg.x_st,
                    blur=blur_matrices(cfg.M, cfg.N, data.grad_kde.dtype))
    return (kde * data.grad_kde + kde + data.grad_kde) / 3.0


def trajectory():
    import functools
    import gaussian_process_edge_trace_tpu as rgpt
    from gaussian_process_edge_trace_tpu.trace import driver as rd
    from torch_reference_1000 import batched_reference_fit
    batched_reference_fit()
    rows = {}
    for name, spec, right, seeds in TRACES:
        grad, init, truth = problem(spec, right)
        for seed in seeds:
            tracer = _tracer(spec, grad, init, seed)
            cfg, data = tracer.cfg, tracer.data
            state = rd.init_state(cfg)
            prev = {f: np.asarray(getattr(state, f))
                    for f in ("obs_x", "obs_y", "obs_valid")}
            step = jax.jit(functools.partial(rd.trace_step, cfg))
            score_map = jax.jit(functools.partial(_score_map, cfg))
            accepted, scores = [], []
            while (int(state.n_fobs) < cfg.algo_thresh
                   and int(state.it) < cfg.max_iters):
                state, samples = step(data, state)
                score = np.asarray(score_map(data, samples))
                cur = {f: np.asarray(getattr(state, f))
                       for f in ("obs_x", "obs_y", "obs_valid")}
                changed = np.nonzero((cur["obs_x"] != prev["obs_x"])
                                     | (cur["obs_y"] != prev["obs_y"])
                                     | (cur["obs_valid"]
                                        != prev["obs_valid"]))[0]
                accepted.append([[int(b), int(cur["obs_x"][b])
                                  if cur["obs_valid"][b] else -1,
                                  int(cur["obs_y"][b])] for b in changed])
                scores.append([float(f"{score[y, x]:.7g}") if v else None
                               for x, y, v in zip(cur["obs_x"], cur["obs_y"],
                                                  cur["obs_valid"])])
                prev = cur
            res = jax.device_get(rd.finish_trace(cfg, data, state))
            mean = np.asarray(res.y_mean, np.float64)
            near = np.nonzero(np.abs(mean - np.floor(mean) - 0.5)
                              <= ROUNDING_PX)[0]
            edge = np.asarray(res.edge_trace)
            row = dict(
                config=name, seed=seed, E=int(edge.shape[0]),
                n_iters=int(res.n_iters),
                iter_nobs=np.asarray(res.iter_nobs)[:int(res.n_iters)]
                .tolist(),
                iter_thresh=np.asarray(res.iter_thresh, np.float64)
                [:int(res.n_iters)].tolist(),
                accepted=accepted, bin_scores=scores,
                trace=edge[:, 0].tolist(),
                near_boundary=near.tolist(),
                theta=np.asarray(res.theta, np.float64).tolist(),
                lml=float(res.lml), final_cost=float(res.final_cost),
                mse=float(rgpt.trace_MSE(edge, truth)),
                dice=float(rgpt.trace_dicecoef(edge, truth)))
            rows[f"{name}/{seed}"] = row
            print(f"{name} seed {seed}: n_iters {row['n_iters']} DICE "
                  f"{row['dice']} MSE {row['mse']} final_cost "
                  f"{row['final_cost']}", flush=True)
    with open(TRAJECTORY_PATH, "w") as f:
        json.dump({"jax": jax.__version__, "rounding_px": ROUNDING_PX,
                   "traces": rows}, f, separators=(",", ":"))
    print(f"{len(rows)} traces -> {TRAJECTORY_PATH} "
          f"({os.path.getsize(TRAJECTORY_PATH)} bytes)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("which", choices=("stream", "trajectory"))
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    {"stream": stream, "trajectory": trajectory}[args.which]()


if __name__ == "__main__":
    main()
