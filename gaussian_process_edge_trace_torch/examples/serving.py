"""Serving modes beyond the reference's one trace per call.

Three ways to share a trace's launches (the reference, gpet.py:768, runs
one image per ``__call__`` and re-runs preprocessing per edge):

1. **Batch**: B complete traces of distinct frames in one loop
   (``trace_batch``).
2. **Multi-edge**: every boundary of one image in one loop, sharing the
   image's preprocessing (``trace_multi_edge``).
3. **Ensemble**: best-of-K seeds in one loop, chosen by the algorithm's own
   final cost (``trace_ensemble``; also ``GP_Edge_Tracing(...)
   (ensemble=K)``).

Run: ``python -m gaussian_process_edge_trace_torch.examples.serving``.
"""

import argparse

import numpy as np

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.parallel import (
    make_batch_data, make_batch_state, trace_batch, trace_ensemble,
    trace_multi_edge)
from gaussian_process_edge_trace_torch.trace.driver import (
    frame_of, init_state, make_config, make_data, run_trace)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    N = 500
    kb = gpt.kernel_builder((11, 5), unit=False)
    kw = dict(kernel_options={"kernel": "RBF", "sigma_f": 75,
                              "length_scale": 20},
              noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
              keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)

    # --- 1. Batch: four distinct frames, one loop ---------------------
    grads, inits, edges = [], [], []
    for s in range(4):
        img, edge = gpt.construct_test_img(
            (N, N), 200, 4, 0.05, "sinusoidal", 0.3, gaps=True, seed=1 + s)
        grads.append(gpt.comp_grad_img(img, kb, device=dev))
        inits.append(edge[[0, -1]][:, [1, 0]])
        edges.append(edge)
    cfg = make_config(inits[0], (N, N), **kw)
    res = trace_batch(cfg, make_batch_data(cfg, grads, np.asarray(inits),
                                           dev),
                      make_batch_state(cfg, 4, dev))
    for f in range(4):
        d = float(gpt.trace_dicecoef(frame_of(res, f).edge_trace, edges[f]))
        print(f"batch frame {f}: iters={int(res.n_iters[f])} DICE={d:.4f}")

    # --- 2. Multi-edge: both boundaries of one image, one loop --------
    img, edge = gpt.construct_test_img((N, N), 120, 3, 0.03,
                                       "multi-sinusoidal", 0.3, gaps=False,
                                       seed=2)
    boundaries = [edge[:N], edge[N:2 * N]]
    grad = gpt.comp_grad_img(img, kb, device=dev)
    me_inits = np.asarray([[[0, e[0, 0]], [N - 1, e[N - 1, 0]]]
                           for e in boundaries])
    cfg_me = make_config(me_inits[0], (N, N), **kw)
    res = trace_multi_edge(cfg_me, grad, me_inits)
    for f, truth in enumerate(boundaries):
        d = float(gpt.trace_dicecoef(frame_of(res, f).edge_trace, truth))
        print(f"multi-edge boundary {f}: iters={int(res.n_iters[f])} "
              f"DICE={d:.4f}")

    # --- 3. Ensemble: best-of-5 seeds, one loop -----------------------
    img, edge = gpt.construct_test_img((N, N), 200, 4, 0.05, "sinusoidal",
                                       0.3, gaps=True, seed=4)
    grad = gpt.comp_grad_img(img, kb, device=dev)
    init = edge[[0, -1]][:, [1, 0]]
    cfg_e = make_config(init, (N, N), **kw)
    data = make_data(cfg_e, grad, init, dev)
    single = run_trace(cfg_e, data, init_state(cfg_e, dev))
    best = trace_ensemble(cfg_e, data, init_state(cfg_e, dev), n_seeds=5)
    print(f"ensemble: single-seed DICE="
          f"{float(gpt.trace_dicecoef(single.edge_trace, edge)):.4f} "
          f"best-of-5 DICE="
          f"{float(gpt.trace_dicecoef(best.edge_trace, edge)):.4f}")


if __name__ == "__main__":
    main()
