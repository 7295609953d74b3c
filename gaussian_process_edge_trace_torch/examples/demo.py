"""End-to-end demo: the reference README walkthrough (README.md:37-89).

Builds the noisy sinusoidal test image with occlusion gaps, computes the
gradient image with the extended-Sobel kernel, traces the edge with fixed
endpoints, and reports the trace metrics. ``--plot`` saves the result
figure (needs matplotlib).

Run: ``python -m gaussian_process_edge_trace_torch.examples.demo``.
"""

import argparse
import time

import numpy as np
import torch

import gaussian_process_edge_trace_torch as gpt


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", action="store_true",
                    help="save the result figure to demo_results.png "
                         "(needs matplotlib)")
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--n-samples", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.plot:
        import matplotlib  # noqa: F401  (before the trace, not after it)

    # 1. Synthetic test image with a known sinusoidal edge, gaps and noise.
    size = (args.size, args.size)
    test_img, true_edge = gpt.construct_test_img(
        size=size, amplitude=200, curvature=4, noise_level=0.05,
        ltype="sinusoidal", intensity=0.3, gaps=True)

    # 2. Gradient image by the extended-Sobel kernel.
    kernel = gpt.kernel_builder(size=(11, 5), unit=False)
    grad_img = gpt.comp_grad_img(test_img, kernel, device=args.device)

    # 3. Trace the edge between the two known endpoints.
    init = true_edge[[0, -1]][:, [1, 0]]   # yx -> xy endpoints
    tracer = gpt.GP_Edge_Tracing(
        init=init, grad_img=grad_img,
        kernel_options={"kernel": "RBF", "sigma_f": 75, "length_scale": 20},
        noise_y=1, obs=np.array([]), N_samples=args.n_samples,
        score_thresh=1, delta_x=5, keep_ratio=0.1, seed=args.seed,
        return_std=True, fix_endpoints=True, device=args.device)

    t0 = time.perf_counter()
    edge_pred, credint = tracer()
    _sync(args.device)
    t1 = time.perf_counter()
    edge_pred, credint = tracer()        # warm: kernels built and loaded
    _sync(args.device)
    t2 = time.perf_counter()

    mse = float(gpt.trace_MSE(edge_pred, true_edge))
    rel = float(gpt.trace_relarea(edge_pred, true_edge))
    dice = float(gpt.trace_dicecoef(edge_pred, true_edge))
    print(f"first call (incl. kernel build/load): {t1 - t0:.2f}s; "
          f"warm: {t2 - t1:.3f}s")
    print(f"MSE: {mse:.3f}  Rel. area diff: {rel:.5f}  DICE: {dice:.4f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        from gaussian_process_edge_trace_torch.utils.plotting import (
            plot_results)
        fig = plot_results(edge_pred, true_edge, test_img,
                           grad_img.cpu().numpy(), credint=credint,
                           show=False)
        fig.savefig("demo_results.png", dpi=120)
        print("wrote demo_results.png")


if __name__ == "__main__":
    main()
