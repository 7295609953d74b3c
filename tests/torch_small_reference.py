"""The JAX package's DICE on the small slice images of the GPU tests
(``tests/test_torch_cuda.py``: 64×96 sinusoidal images of seeds 1 and 2,
RBF σf = 20, ℓ = 8, S = 256, δx = 6), over tracer seeds: the spread that a
DICE gate on one seed's trace of these images has to allow.

Run from the repository root on a CPU (a few seconds per seed):

    JAX_PLATFORMS=cpu python tests/torch_small_reference.py --seeds 1 ... 30

The reference's final fit takes its batched path, as on the TPU, with XLA's
LAPACK Cholesky and triangular solves (``tests/torch_reference_1000.py``).
One line per image seed gives the sorted DICE and how many fall at or below
0.97; the last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gaussian_process_edge_trace_tpu as rgpt  # noqa: E402
from gaussian_process_edge_trace_tpu.trace import driver as rd  # noqa: E402
from torch_reference_1000 import batched_reference_fit  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="*", default=list(range(1, 31)))
    p.add_argument("--images", type=int, nargs="*", default=[1, 2])
    args = p.parse_args(argv)
    batched_reference_fit()
    rows = {}
    for image in args.images:
        img, edge = rgpt.construct_test_img((64, 96), 40, 2, 0.03,
                                            "sinusoidal", 0.3, seed=image)
        grad = rgpt.comp_grad_img(img, rgpt.kernel_builder((9, 5)))
        init = np.array([[0, edge[0, 0]], [95, edge[95, 0]]])
        dice = []
        for seed in args.seeds:
            cfg = rd.make_config(init, (64, 96), {
                "kernel": "RBF", "sigma_f": 20, "length_scale": 8},
                N_samples=256, delta_x=6, pixel_thresh=4, seed=seed)
            res = rd.run_trace(cfg, rd.make_data(cfg, grad, jnp.asarray(init)),
                               rd.init_state(cfg))
            dice.append(float(rgpt.trace_dicecoef(np.asarray(res.edge_trace),
                                                  edge)))
        rows[image] = dice
        low = sum(d <= 0.97 for d in dice)
        print(f"image seed {image}: DICE over tracer seeds {args.seeds[0]}-"
              f"{args.seeds[-1]}: {sorted(round(d, 4) for d in dice)}; "
              f"{low} of {len(dice)} at or below 0.97", flush=True)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
