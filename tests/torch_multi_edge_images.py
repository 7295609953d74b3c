"""Two edges of one 500² image traced together (``trace_multi_edge``) on
the CPU, on ``construct_test_img``'s ``multi-sinusoidal`` images (the second
boundary A/2 rows below the first) and on the two-band image of
``chip_smoke.py``'s multi-edge phase (one sinusoidal boundary in each of two
stacked 250×500 bands).

Run from the repository root (about a minute on 4 cores):

    python tests/torch_multi_edge_images.py

One JSON line per case: the image and tracer settings, and per edge the
iterations, the median |row offset| of the trace from its true edge and the
DICE. On every multi-sinusoidal case one edge's trace, or both, lies
largely on the other boundary (a median offset near the boundaries'
separation of A/2 rows), whatever the intensity, curvature, kernel or warm
start; on the two-band image both edges trace their own boundary. The port's CPU path takes the JAX package's pixels
from the JAX package's draws (``tests/test_torch_batch.py``), so this is the
algorithm's behaviour, not the port's.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import gaussian_process_edge_trace_torch as gpt  # noqa: E402
from gaussian_process_edge_trace_torch.parallel import (  # noqa: E402
    trace_multi_edge)
from gaussian_process_edge_trace_torch.trace.driver import (  # noqa: E402
    make_config)

N = 500
DEMO_KERNEL = {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}
# (name, image settings, kernel, warm-start observations per edge, seed)
CASES = (
    ("multi-sinusoidal, demo image settings", dict(amplitude=200,
     curvature=4, noise_level=0.05, intensity=0.3), DEMO_KERNEL, 0, 1),
    ("multi-sinusoidal, another tracer seed", dict(amplitude=200,
     curvature=4, noise_level=0.05, intensity=0.3), DEMO_KERNEL, 0, 2),
    ("multi-sinusoidal, equal contrasts", dict(amplitude=100, curvature=2,
     noise_level=0.01, intensity=0.35), DEMO_KERNEL, 0, 1),
    ("multi-sinusoidal, first edge stronger", dict(amplitude=100,
     curvature=2, noise_level=0.01, intensity=0.38), DEMO_KERNEL, 0, 1),
    ("multi-sinusoidal, one period", dict(amplitude=200, curvature=1,
     noise_level=0.01, intensity=0.36), DEMO_KERNEL, 0, 1),
    ("multi-sinusoidal, a narrower prior", dict(amplitude=200, curvature=4,
     noise_level=0.05, intensity=0.3),
     {"kernel": "RBF", "sigma_f": 30, "length_scale": 20}, 0, 1),
    ("multi-sinusoidal, 3 warm-start points per edge", dict(amplitude=200,
     curvature=4, noise_level=0.05, intensity=0.3), DEMO_KERNEL, 3, 1),
    ("two sinusoidal bands (chip_smoke.py)", None, DEMO_KERNEL, 0, 1),
)


def image(settings):
    """(image, [edge 0, edge 1]) of one case."""
    if settings is None:
        from chip_smoke import multi_edge_image
        return multi_edge_image()
    img, edge = gpt.construct_test_img((N, N), ltype="multi-sinusoidal",
                                       gaps=False, seed=2, **settings)
    return img, [edge[:N], edge[N:2 * N]]


def main() -> int:
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    for name, settings, kernel, n_obs, seed in CASES:
        img, edges = image(settings)
        grad = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5),
                                                         unit=False),
                                 device="cpu")
        inits = np.asarray([[[0, e[0, 0]], [N - 1, e[N - 1, 0]]]
                            for e in edges])
        xs = np.linspace(0, N - 1, n_obs + 2)[1:-1].astype(int)
        obs = (np.asarray([[[x, e[x, 0]] for x in xs] for e in edges])
               if n_obs else None)
        cfg = make_config(inits[0], (N, N), kernel, n_user_obs=n_obs,
                          N_samples=1000, delta_x=5, keep_ratio=0.1,
                          pixel_thresh=5, seed=seed)
        res = trace_multi_edge(cfg, grad, inits, user_obs_xy=obs,
                               device="cpu")
        row = {"case": name, "image": settings, "kernel": kernel,
               "warm_start_points": n_obs, "seed": seed, "edges": []}
        for f, e in enumerate(edges):
            rows = res.edge_trace[f][:, 0].numpy()
            row["edges"].append({
                "n_iters": int(res.n_iters[f]),
                "median_offset_rows": float(np.median(np.abs(
                    rows - e[:, 0]))),
                "dice": float(gpt.trace_dicecoef(res.edge_trace[f].numpy(),
                                                 e))})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
