"""The two packages' batched LML optimisers (screen, then damped-Newton
polish) on the final-fit training sets of ``tests/test_torch_branches.py``'s
eight branches, in float32 and in float64, from identical inputs: the
port's standardised training set and starts, captured from its replay of
the reference's draws.

Run from the repository root on a CPU:

    JAX_PLATFORMS=cpu python tests/torch_polish_witness.py [case ...]

One JSON line per case and precision: the port's and the reference's θ and
LML, the largest θ gap and the LML gap.
``test_torch_branches.py::test_polish_agrees_in_float64`` holds the float64
rows; the float32 rows show how far the same algorithm drifts when only the
rounding of the two LML implementations differs.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import test_torch_branches as branches  # noqa: E402


def main(argv=None):
    cases = (argv if argv is not None else sys.argv[1:]) or list(
        branches.CASES)
    for case in cases:
        cfg, _, _, _, _, fit = branches.replay(case)
        for dtype in ("float32", "float64"):
            t0 = time.perf_counter()
            (th_p, lml_p), (th_r, lml_r) = branches.optimise_both(cfg, fit,
                                                                  dtype)
            print(json.dumps({
                "case": case, "dtype": dtype,
                "theta": [th_p.tolist(), th_r.tolist()],
                "lml": [lml_p, lml_r],
                "theta_max_gap": float(np.abs(th_p - th_r).max()),
                "lml_gap": abs(lml_p - lml_r),
                "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
