"""The JAX package's own readings on the warm-started frame sequence of
``benchmarks/suite.py`` (its config 5): three frames of one 500² sinusoidal
image, each with N(0, 0.02) noise from ``RandomState(0)``, traced by
``trace_sequence`` (frame 0 cold, frames 1-2 warm-started from the previous
frame's accepted pixels) with the demo's RBF σf = 75, ℓ = 20, S = 1000,
δx = 5. ``chip_smoke.py``'s ``sequence_demo_3`` phase traces the same frames
with the PyTorch port and sets its DICE gates from these readings.

Run from the repository root on a CPU (about a minute per tracer seed):

    JAX_PLATFORMS=cpu python tests/torch_sequence_reference.py --seeds 1 2 3

The reference's final fit takes its batched path, as on the TPU, with XLA's
LAPACK Cholesky and triangular solves in place of the Pallas kernels (as
``tests/torch_reference_1000.py`` does). One line per tracer seed gives
each frame's iterations, MSE and DICE against the base image's edge; the
last line is one JSON object of all rows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

import gaussian_process_edge_trace_tpu as rgpt  # noqa: E402
from gaussian_process_edge_trace_tpu.parallel import (  # noqa: E402
    trace_sequence)
from gaussian_process_edge_trace_tpu.trace.driver import (  # noqa: E402
    make_config)
from torch_reference_1000 import batched_reference_fit  # noqa: E402

N_FRAMES = 3


def sequence_frames():
    """``(grads, inits, base_edge)`` of the suite's config 5
    (``benchmarks/suite.py:307-318``)."""
    rngf = np.random.RandomState(0)
    kb = rgpt.kernel_builder((11, 5), unit=False)
    base_img, base_edge = rgpt.construct_test_img(
        (500, 500), 200, 4, 0.03, "sinusoidal", 0.3, gaps=False)
    grads, inits = [], []
    for _ in range(N_FRAMES):
        img = np.clip(base_img + rngf.normal(0, 0.02, base_img.shape), 0, 1)
        grads.append(np.asarray(rgpt.comp_grad_img(img, kb), np.float32))
        inits.append(base_edge[[0, -1]][:, [1, 0]])
    return grads, inits, base_edge


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="*", default=[1])
    args = p.parse_args(argv)
    batched_reference_fit()
    grads, inits, edge = sequence_frames()
    rows = []
    for seed in args.seeds:
        cfg = make_config(inits[0], (500, 500),
                          kernel_options={"kernel": "RBF", "sigma_f": 75,
                                          "length_scale": 20},
                          noise_y=1, N_samples=1000, score_thresh=1,
                          delta_x=5, keep_ratio=0.1, pixel_thresh=5,
                          seed=seed, fix_endpoints=True)
        t0 = time.perf_counter()
        res = trace_sequence(cfg, grads, inits)
        row = {"seed": seed, "seconds": round(time.perf_counter() - t0, 1),
               "n_iters": [int(r.n_iters) for r in res],
               "mse": [float(rgpt.trace_MSE(np.asarray(r.edge_trace), edge))
                       for r in res],
               "dice": [float(rgpt.trace_dicecoef(np.asarray(r.edge_trace),
                                                  edge)) for r in res]}
        print(f"seed {seed}: n_iters {row['n_iters']} MSE {row['mse']} "
              f"DICE {row['dice']} ({row['seconds']} s)", flush=True)
        rows.append(row)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
