"""The final fit's screen of one demo trace on a device, against float64.

Runs ``chip_smoke.py``'s demo config at a tracer seed through
``GP_Edge_Tracing(...)()`` on the device and prints, as one JSON line, the
fit's θ and LML, the JAX package's (from tests/jax_trajectory_fixture.json)
and, for each of the damped-Newton polish's starts, its screen value in the
device's float32 beside the same LML in float64 on the CPU (the same
float32 training set), then its value after each polish step. Imports no
JAX, so it runs on the card as on the CPU::

    python3 tests/torch_fit_probe.py cuda 2
"""

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gaussian_process_edge_trace_torch.models import gpr, newton  # noqa: E402
from gaussian_process_edge_trace_torch.trace import driver as pd  # noqa: E402


def probe(dev, seed):
    seen = {"steps": []}
    screen, step, optimize = newton._screen, newton._damped_step, \
        pd.optimize_lml

    def screen_(f0s, starts, n_polish):
        X, F = screen(f0s, starts, n_polish)
        seen["X"], seen["F"] = X, F
        return X, F

    def step_(*a):
        X, F = step(*a)
        seen["steps"].append(F[0].double().cpu().tolist())
        return X, F

    def optimize_(kernel, xs, ys, mask, noise_w, *a, jitter=1e-6, **k):
        seen["args"] = (kernel, xs, ys, mask, noise_w, jitter)
        return optimize(kernel, xs, ys, mask, noise_w, *a, jitter=jitter,
                        **k)

    newton._screen, newton._damped_step = screen_, step_
    pd.optimize_lml = optimize_
    try:
        tracer = cs.demo_config(dev).tracer(seed)
        tracer()
    finally:
        newton._screen, newton._damped_step = screen, step
        pd.optimize_lml = optimize
    res = tracer.last_result
    kernel, xs, ys, mask, noise_w, jitter = seen["args"]
    cpu = torch.device("cpu")
    lml64 = -gpr.batched_lml(
        kernel, xs[0].to(cpu, torch.float64), ys[0].to(cpu, torch.float64),
        mask[0].cpu(), seen["X"][0].to(cpu, torch.float64),
        noise_w.to(cpu, torch.float64), jitter=jitter)
    with open(cs.TRAJECTORY_FIXTURE) as f:
        ref = json.load(f)["traces"][f"demo/{seed}"]
    return {"device": str(dev), "seed": seed, "theta": res.theta.tolist(),
            "lml": float(res.lml), "jax_theta": ref["theta"],
            "jax_lml": ref["lml"],
            "starts": seen["X"][0].double().cpu().tolist(),
            "screen_f32": seen["F"][0].double().cpu().tolist(),
            "screen_f64": lml64.tolist(), "steps": seen["steps"]}


if __name__ == "__main__":
    print(json.dumps(probe(torch.device(sys.argv[1]),
                           int(sys.argv[2]) if len(sys.argv) > 2 else 2)))
