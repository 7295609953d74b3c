"""The JAX package's DICE on the denoised 1000² pipeline, over tracer
seeds: the spread that ``chip_smoke.py``'s ``denoised_trace_1000`` gates
have to allow.

The pipeline is the 1000² config's (``benchmarks/suite.py`` config 4, the
suite's image of seed 1 with its noise), with the image first denoised by
``denoise(img, 'tvc', {})`` (Chambolle TV, weight 0.1, 100 iterations),
then ``comp_grad_img`` with the 11×5 extended Sobel, then the trace (RBF
σf = 200, ℓ = 50, S = 10⁴, δx = 5). Run from the repository root on a CPU
(about a minute per seed, ~2.5 GB):

    JAX_PLATFORMS=cpu python tests/torch_denoised_reference.py --seeds 1 ... 10

The reference's final fit takes its batched path, as on the TPU, with XLA's
LAPACK Cholesky and triangular solves (``tests/torch_reference_1000.py``).
One JSON line per seed, then one with the sorted DICE.

Its readings over tracer seeds 1-12 on a CPU: 0.9853, 0.9885, 0.9906,
0.9911, 0.9918, 0.9922, 0.9932, 0.9938, 0.9942, 0.9942, 0.9944, 0.9952
(median 0.9927; 17-20 iterations). ``chip_smoke.py::DENOISED_GATES``
(median > 0.985, every seed > 0.975) lies below that spread.
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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import gaussian_process_edge_trace_tpu as rgpt  # noqa: E402
from gaussian_process_edge_trace_tpu.trace import driver as rd  # noqa: E402
from torch_parity import BIG_IMG, BIG_KW  # noqa: E402
from torch_reference_1000 import batched_reference_fit  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="*", default=list(range(1, 11)))
    args = p.parse_args(argv)
    batched_reference_fit()
    img, edge = rgpt.construct_test_img(**BIG_IMG)
    den = rgpt.denoise(img, "tvc", {})
    grad = rgpt.comp_grad_img(den, rgpt.kernel_builder((11, 5), unit=False))
    init = edge[[0, -1]][:, [1, 0]]
    data = None
    dice = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        cfg = rd.make_config(init, grad.shape, **dict(BIG_KW, seed=seed))
        if data is None:
            data = rd.make_data(cfg, grad, jnp.asarray(init))
        res = rd.run_trace(cfg, data, rd.init_state(cfg))
        d = float(rgpt.trace_dicecoef(np.asarray(res.edge_trace), edge))
        dice.append(d)
        print(json.dumps({"seed": seed, "dice": d,
                          "n_iters": int(res.n_iters),
                          "seconds": round(time.perf_counter() - t0, 1)}),
              flush=True)
    print(json.dumps({"sorted_dice": sorted(dice),
                      "median": float(np.median(dice)), "min": min(dice)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
