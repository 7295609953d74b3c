"""Checkpoint and resume: interrupt a trace mid-loop, save it with its
config and data fingerprint, load it back and finish; the resumed result
is the uninterrupted run's.

Run: ``python -m gaussian_process_edge_trace_torch.examples.checkpoint_resume``.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.trace.checkpoint import (
    load_checkpoint, resume_trace, save_checkpoint)
from gaussian_process_edge_trace_torch.trace.driver import (
    init_state, make_config, make_data, run_trace, trace_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    img, edge = gpt.construct_test_img((128, 128), 40, 2, 0.02,
                                       "sinusoidal", 0.3, gaps=False)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((7, 3)), device=dev)
    init = np.array([[0, edge[0, 0]], [127, edge[127, 0]]])
    cfg = make_config(init, tuple(grad.shape),
                      kernel_options={"kernel": "RBF", "sigma_f": 30,
                                      "length_scale": 10},
                      noise_y=1, N_samples=256, score_thresh=0.5,
                      delta_x=6, keep_ratio=0.1, pixel_thresh=4, seed=1,
                      fix_endpoints=True)
    data = make_data(cfg, grad, init, dev)

    full = run_trace(cfg, data, init_state(cfg, dev))
    print(f"uninterrupted: {int(full.n_iters)} iterations")

    # Run two iterations, then "crash" and checkpoint.
    state, _ = trace_step(cfg, data, init_state(cfg, dev))
    state, _ = trace_step(cfg, data, state)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.npz")
        save_checkpoint(path, cfg, state, data=data)
        print("checkpointed after 2 iterations")
        # Another process would rebuild the config from the file; the
        # fingerprint check refuses to resume on another image.
        cfg2, state2 = load_checkpoint(path, expect_cfg=cfg, data=data)
    resumed = resume_trace(cfg2, data, state2)
    same = bool(torch.equal(resumed.edge_trace, full.edge_trace))
    print(f"resumed: {int(resumed.n_iters)} iterations total; "
          f"identical trace to uninterrupted run: {same}")
    mse = float(gpt.trace_MSE(resumed.edge_trace, edge))
    print(f"MSE vs ground truth: {mse:.2f}")
    if not same:
        raise SystemExit("the resumed trace differs from the uninterrupted "
                         "one")


if __name__ == "__main__":
    main()
