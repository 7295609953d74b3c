"""Image-sequence tracing with warm starts.

Traces an edge through a stack of noisy frames, handing each frame's
accepted observations to the next frame's first GP fit (the reference's
``obs`` mechanism, gpet.py:57-61): warm-started frames converge in a few
iterations or none, where a cold trace takes about a dozen.

Run: ``python -m gaussian_process_edge_trace_torch.examples.sequence``.
"""

import argparse
import time

import numpy as np
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.parallel import trace_sequence
from gaussian_process_edge_trace_torch.trace.driver import make_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=5)
    args = ap.parse_args(argv)
    rng = np.random.RandomState(0)
    base_img, base_edge = gpt.construct_test_img(
        (500, 500), 200, 4, 0.03, "sinusoidal", 0.3, gaps=False)
    kb = gpt.kernel_builder((11, 5), unit=False)

    frames, inits = [], []
    for _ in range(args.frames):
        img = np.clip(base_img + rng.normal(0, 0.02, base_img.shape), 0, 1)
        frames.append(gpt.comp_grad_img(img, kb, device=args.device))
        inits.append(base_edge[[0, -1]][:, [1, 0]])
    frames = torch.stack(frames)

    cfg = make_config(inits[0], (500, 500),
                      kernel_options={"kernel": "RBF", "sigma_f": 75,
                                      "length_scale": 20},
                      noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
                      keep_ratio=0.1, pixel_thresh=5, seed=1,
                      fix_endpoints=True)

    trace_sequence(cfg, frames[:2], inits[:2])   # warm-up: cold and warm
    t0 = time.perf_counter()
    results = trace_sequence(cfg, frames, inits)
    dt = time.perf_counter() - t0
    print(f"{args.frames} frames in {dt:.2f}s "
          f"({dt / args.frames * 1e3:.0f} ms/frame, host included)")
    for f, res in enumerate(results):
        mse = float(gpt.trace_MSE(res.edge_trace, base_edge))
        print(f"frame {f}: iters={int(res.n_iters)} MSE={mse:.2f}")


if __name__ == "__main__":
    main()
