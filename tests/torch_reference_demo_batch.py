"""The JAX package's DICE on the demo batch frames, traced one at a time.

Run from the repository root on a CPU (a few seconds per frame after one
compile; the frames share one config):

    JAX_PLATFORMS=cpu python tests/torch_reference_demo_batch.py --images 256

``--right-end 498`` puts the right endpoint one column in, so the edge
length E = 499 is odd and the JAX package scores every iteration's curves
on its unfused path (column interpolation, then the Simpson sums with their
even-count tails); MSE and DICE are then taken against the true edge's
first 499 columns.

The frames are those of ``benchmarks/suite.py`` config 1b/1d
(:109-119): the README demo config (500×500, amplitude 200, gaps, RBF
σf=75 ℓ=20, S=1000, δx=5) on image seeds 1..N, traced by the JAX
package's ``run_trace`` at tracer seed 1, each frame alone. The reference's
final fit takes its batched path, as on the TPU, with XLA's LAPACK
Cholesky and triangular solves in place of the Pallas kernels
(``torch_reference_1000.batched_reference_fit``). One line per frame, then
one JSON object with every frame's DICE and iterations and the median DICE
over image seeds 1-16, 1-64, 1-128 and 1-256 (those within ``--images``),
which set ``chip_smoke.py``'s ``BATCH_THROUGHPUT_GATES`` (E = 500) and
``ODD_BATCH_GATES`` (E = 499).
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gaussian_process_edge_trace_tpu as rgpt  # noqa: E402
from gaussian_process_edge_trace_tpu.trace import driver as rd  # noqa: E402
from torch_reference_1000 import batched_reference_fit  # noqa: E402

DEMO_KW = dict(kernel_options={"kernel": "RBF", "sigma_f": 75,
                               "length_scale": 20},
               noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
               keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
WIDTHS = (16, 64, 128, 256)


def frame(image_seed, right_end=499):
    """``(grad, init, edge)`` of the demo image of ``image_seed``, the
    endpoints at columns 0 and ``right_end``, the edge cut to them."""
    img, edge = rgpt.construct_test_img((500, 500), 200, 4, 0.05,
                                        "sinusoidal", 0.3, gaps=True,
                                        seed=image_seed)
    grad = np.asarray(rgpt.comp_grad_img(
        jnp.asarray(img), rgpt.kernel_builder((11, 5), unit=False)))
    return grad, edge[[0, right_end]][:, [1, 0]], edge[:right_end + 1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--images", type=int, default=256,
                   help="trace image seeds 1..N")
    p.add_argument("--seed", type=int, default=1, help="tracer seed")
    p.add_argument("--right-end", type=int, default=499,
                   help="column of the right endpoint (499: the last)")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    batched_reference_fit()
    rows = []
    cfg = None
    for s in range(1, args.images + 1):
        grad, init, edge = frame(s, args.right_end)
        if cfg is None:
            cfg = rd.make_config(init, grad.shape,
                                 **dict(DEMO_KW, seed=args.seed))
        t0 = time.perf_counter()
        data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
        res = jax.device_get(rd.run_trace(cfg, data, rd.init_state(cfg)))
        row = {"image_seed": s, "n_iters": int(res.n_iters),
               "dice": float(rgpt.trace_dicecoef(
                   np.asarray(res.edge_trace), edge)),
               "mse": float(rgpt.trace_MSE(np.asarray(res.edge_trace),
                                           edge)),
               "seconds": round(time.perf_counter() - t0, 2)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    dice = np.array([r["dice"] for r in rows])
    iters = np.array([r["n_iters"] for r in rows])
    summary = {
        f"1-{b}": {"median_dice": float(np.median(dice[:b])),
                   "min_dice": float(dice[:b].min()),
                   "median_iters": float(np.median(iters[:b])),
                   "max_iters": int(iters[:b].max())}
        for b in WIDTHS if b <= len(rows)}
    print(json.dumps({"tracer_seed": args.seed,
                      "edge_length": args.right_end + 1, "summary": summary,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
