"""The 2000² S=10³ config and the two non-square configs of
``benchmarks/suite.py`` (configs 4b and 4c) traced by the JAX package on a
CPU, and by the PyTorch port's CPU path from the same random draws.

Run from the repository root on a CPU:

    JAX_PLATFORMS=cpu python tests/torch_reference_2000.py \
        --reference-only 1 2 3 --seeds 1
    JAX_PLATFORMS=cpu python tests/torch_reference_2000.py \
        --config 512x1536 --reference-only 1 --seeds 1
    JAX_PLATFORMS=cpu python tests/torch_reference_2000.py \
        --config 1536x512 --reference-only 1 --seeds 1

``--config 2000`` (the default) is config 4b: the 2000² image (amplitude
700, curvature 4, noise 0.05, sinusoidal, gaps), RBF σf = 400, ℓ = 100,
S = 1000, δx = 5, keep_ratio 0.1, pixel_thresh 5, fixed endpoints. Its
n_train of 408 takes the coarse-to-fine final fit over the blocked
Cholesky and solves. ``512x1536`` and ``1536x512`` are config 4c's pair
(amplitude 150, σf = 100, ℓ = 60 and 30). Each image is the suite's: image
seed 1, the gradient an 11×5 extended Sobel.

For each seed of ``--reference-only`` the reference's ``run_trace`` runs
alone; for each seed of ``--seeds`` the reference and the port step in
lockstep from the reference's draws (``torch_reference_1000.lockstep``),
then each package's final fit, and the port's fit on the reference's final
training set (:func:`on_reference_set`). The reference's final fit takes
its batched path, as on the TPU, with XLA's LAPACK Cholesky and triangular
solves in place of the Pallas kernels. One line per seed reports the
iterations, MSE and DICE against the true edge (and, replayed, whether the
accepted pixels are the same, how far the final fits are apart, and on the
reference's training set the port's LML and mean at the reference's θ and
its own optimum); the last line is one JSON object of all rows.
``chip_smoke.py``'s 2000² DICE gates and the non-square MSE gates rest on
these readings. The command exits 1 if a
replayed seed differs other than through its samples.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import gaussian_process_edge_trace_tpu as rgpt  # noqa: E402
from gaussian_process_edge_trace_torch import interop  # noqa: E402
from gaussian_process_edge_trace_torch.models.kernels import (  # noqa: E402
    k_unit_np)
from gaussian_process_edge_trace_torch.trace import driver as pd  # noqa: E402
from gaussian_process_edge_trace_tpu.trace import driver as rd  # noqa: E402
from torch_parity import JaxDraws  # noqa: E402
from torch_reference_1000 import (  # noqa: E402
    batched_reference_fit, lockstep, scores)

# (image size, amplitude, σf, ℓ) of benchmarks/suite.py:254-305.
CONFIGS = {"2000": ((2000, 2000), 700, 400, 100),
           "512x1536": ((512, 1536), 150, 100, 60),
           "1536x512": ((1536, 512), 150, 100, 30)}


def problem(name):
    """``(edge, grad, init, tracer kwargs)`` of one config, built by the JAX
    package as ``benchmarks/suite.py`` builds it."""
    size, amp, sf, ls = CONFIGS[name]
    img, edge = rgpt.construct_test_img(size, amp, 4, 0.05, "sinusoidal",
                                        0.3, gaps=True)
    grad = np.asarray(rgpt.comp_grad_img(
        jnp.asarray(img), rgpt.kernel_builder((11, 5), unit=False)),
        np.float32)
    init = edge[[0, -1]][:, [1, 0]]
    kw = dict(kernel_options={"kernel": "RBF", "sigma_f": sf,
                              "length_scale": ls},
              noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
              keep_ratio=0.1, pixel_thresh=5, fix_endpoints=True)
    return edge, grad, init, kw


def mean_f64(kernel, jitter, train, x_grid, theta):
    """The posterior mean (pixels) in float64 by a dense solve: the value
    both packages' float32 fits approximate."""
    x, y, mask, noise_w = (t.numpy() for t in train)
    xf, yf = x[mask].astype(np.float64), y[mask].astype(np.float64)
    xs, ys = (xf - xf.mean()) / xf.std(), (yf - yf.mean()) / yf.std()
    c, ls, nz = np.exp(np.asarray(theta, np.float64))
    K = c * k_unit_np(kernel, np.abs(xs[:, None] - xs[None, :]) / ls)
    K[np.diag_indices_from(K)] += nz * noise_w[mask] + jitter
    xq = (x_grid.numpy().astype(np.float64) - xf.mean()) / xf.std()
    Kq = c * k_unit_np(kernel, np.abs(xq[:, None] - xs[None, :]) / ls)
    return yf.std() * (Kq @ np.linalg.solve(K, ys)) + yf.mean()


def on_reference_set(cfg, data, ref):
    """The port's final fit on the reference's final training set, so that
    a fault of its fit (at n_train > 223 the blocked K5/K6 path) can be
    told apart from loops that part and from the LML's ridge: the port's
    LML and posterior mean at the reference's θ, each beside the
    reference's and the float64 value (the LML through ``torch.linalg``,
    the mean by a dense solve), and the port's own optimum from the
    reference's restart draws."""
    pcfg, pdata, _ = interop.from_reference(
        cfg._asdict(), jax.device_get(data._asdict()),
        jax.device_get(rd.init_state(cfg)._asdict()), device="cpu")
    pad = cfg.n_train - cfg.n_inits - cfg.n_user_obs - cfg.bins.n_bins
    zeros = torch.zeros(pad, dtype=torch.int64)
    train = (torch.cat([pdata.init_x, torch.as_tensor(np.asarray(ref.obs_x)),
                        zeros]),
             torch.cat([pdata.init_y, torch.as_tensor(np.asarray(ref.obs_y)),
                        zeros]),
             torch.cat([torch.ones(cfg.n_inits, dtype=torch.bool),
                        torch.as_tensor(np.asarray(ref.obs_valid)),
                        torch.zeros(pad, dtype=torch.bool)]),
             torch.cat([torch.full((cfg.n_inits,), cfg.init_noise_weight),
                        torch.ones(cfg.n_train - cfg.n_inits)]))
    restarts = JaxDraws(pcfg, pdata.L_prior_unit.shape[1]).restarts()
    theta = torch.as_tensor(np.asarray(ref.theta))
    lml = {}

    def at_ref_theta(kernel, xs, ys, mask, noise_w, *a, jitter, **k):
        lml["at_ref_theta"] = float(pd.batched_lml(
            kernel, xs, ys, mask, theta[None], noise_w, jitter=jitter)[0])
        lml["f64"] = float(pd.library_lml(
            kernel, xs, ys, mask, theta.double(), noise_w, jitter=jitter))
        return theta, torch.tensor(lml["at_ref_theta"])
    optimize_lml, pd.optimize_lml = pd.optimize_lml, at_ref_theta
    try:
        mean_at_ref = pd._final_fit_buffers(pcfg, pdata, restarts, *train)[0]
    finally:
        pd.optimize_lml = optimize_lml
    mean, _, _, own_theta, own_lml = pd._final_fit_buffers(
        pcfg, pdata, restarts, *train)
    ref_mean = np.asarray(ref.y_mean)
    exact = mean_f64(pcfg.kernel, cfg.gp_jitter, train, pdata.x_grid,
                     np.asarray(ref.theta))
    return {"ref_set_lml_at_ref_theta": [lml["at_ref_theta"],
                                         float(ref.lml), lml["f64"]],
            "ref_set_mean_gap_at_ref_theta_px": float(np.abs(
                mean_at_ref.numpy() - ref_mean).max()),
            "ref_set_f64_mean_gap_at_ref_theta_px": [
                float(np.abs(mean_at_ref.numpy() - exact).max()),
                float(np.abs(ref_mean - exact).max())],
            "ref_set_own_fit": {
                "lml": float(own_lml), "theta": own_theta.tolist(),
                "mean_max_gap_px": float(np.abs(mean.numpy()
                                                - ref_mean).max())}}


def run_seed(seed, edge, grad, init, kw, replay):
    cfg = rd.make_config(init, grad.shape, **dict(kw, seed=seed))
    data = rd.make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = rd.init_state(cfg)
    row = {"seed": seed, "n_train": cfg.n_train}
    t0 = time.perf_counter()
    if replay:
        ref, got, info = lockstep(cfg, data, state0)
    else:
        ref = jax.device_get(rd.run_trace(cfg, data, state0))
    row["seconds"] = round(time.perf_counter() - t0, 1)
    n = int(ref.n_iters)
    row["ref_iters"] = n
    row["ref_mse"], row["ref_dice"] = scores(ref.edge_trace, edge)
    if replay:
        row["port_iters"] = got.n_iters
        row["same_pixels"] = got.n_iters == n and all(
            np.array_equal(getattr(got, f).numpy(),
                           np.asarray(getattr(ref, f)))
            for f in ("obs_x", "obs_y", "obs_valid", "iter_nobs"))
        row.update(info)
        dy = got.edge_trace.numpy()[:, 0] != np.asarray(ref.edge_trace)[:, 0]
        row["trace_cols_differ"] = int(dy.sum())
        row["mean_max_gap_px"] = float(np.abs(
            got.y_mean.numpy() - np.asarray(ref.y_mean)).max())
        row["port_mse"], row["port_dice"] = scores(got.edge_trace.numpy(),
                                                   edge)
        row["lml"] = [float(got.lml), float(ref.lml)]
        row.update(on_reference_set(cfg, data, ref))
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="2000")
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--reference-only", type=int, nargs="*", default=[1, 2, 3])
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    batched_reference_fit()
    edge, grad, init, kw = problem(args.config)
    rows = []
    for seed, replay in ([(s, False) for s in args.reference_only]
                         + [(s, True) for s in args.seeds]):
        row = dict(config=args.config, **run_seed(seed, edge, grad, init, kw,
                                                  replay))
        print(json.dumps(row), flush=True)
        rows.append(row)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**10
    print(json.dumps({"rows": rows, "peak_rss_mib": round(peak, 1)}))
    return 0 if all(r.get("same_pixels", True)
                    or r["port_on_ref_samples_selects_ref_pixels"]
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
