"""Command-line interface: ``python -m gaussian_process_edge_trace_torch``
(or the ``gpet-torch`` console script).

Port of the JAX package's CLI (``gaussian_process_edge_trace_tpu/
__main__.py``), with its subcommands, flags and defaults: load an image
(``.npy``, or anything ``matplotlib.image.imread`` reads), optionally
compute the gradient image, trace one edge between two endpoints, write the
result as ``.npz``.

Subcommands:
  trace  trace an edge in an image file
  batch  trace a batch of same-shaped images in one loop
         (``parallel.trace_batch``), or a warm-started sequence with
         ``--sequence`` (``parallel.trace_sequence``)
  demo   points to ``python -m gaussian_process_edge_trace_torch.examples.demo``

``--device`` (``cuda`` by default) says where the trace runs; ``--device
cpu`` runs the kernels' plain versions. The JAX CLI's
``--compilation-cache`` has no counterpart: nothing is compiled per call,
and the kernels build once into ``build/gpet_torch_kernels/``, named by a
digest of their sources.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _matplotlib(what):
    """Import matplotlib for ``what``, or raise an ImportError naming it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"{what} needs matplotlib, which is not "
                          "installed") from e
    return matplotlib


def _load_image(path):
    if str(path).endswith(".npy"):
        return np.load(path)
    _matplotlib(f"reading {path} (anything but .npy)")
    import matplotlib.image as mpimg
    img = mpimg.imread(path)
    if img.ndim == 3:
        img = img[..., :3].mean(axis=-1)   # luminance
    return np.asarray(img, dtype=np.float64)


def _parse_xy(s):
    x, y = s.split(",")
    return [int(x), int(y)]


def _kernel_options(args):
    opts = {"kernel": args.kernel, "sigma_f": args.sigma_f,
            "length_scale": args.length_scale}
    if args.kernel == "Matern":
        opts["nu"] = args.nu
    return opts


def _grad_of(img, args, gpt):
    """The gradient image on ``args.device``: the input itself with
    ``--is-gradient``, else ``comp_grad_img`` with the extended-Sobel
    kernel of ``--grad-kernel``."""
    if args.is_gradient:
        import torch
        return torch.as_tensor(np.asarray(img, np.float32),
                               device=args.device)
    kernel = gpt.kernel_builder(tuple(args.grad_kernel), unit=False)
    return gpt.comp_grad_img(img, kernel, device=args.device)


def _numpy(t):
    return t.detach().cpu().numpy()


def cmd_trace(args):
    import gaussian_process_edge_trace_torch as gpt

    grad = _grad_of(_load_image(args.image), args, gpt)
    init = np.asarray([_parse_xy(args.init[0]), _parse_xy(args.init[1])])
    if args.plot:
        _matplotlib("--plot")
    tracer = gpt.GP_Edge_Tracing(
        init=init, grad_img=grad, kernel_options=_kernel_options(args),
        noise_y=args.noise_y, obs=np.zeros((0, 2), np.int64),
        N_samples=args.n_samples, score_thresh=args.score_thresh,
        delta_x=args.delta_x, keep_ratio=args.keep_ratio,
        pixel_thresh=args.pixel_thresh, seed=args.seed, return_std=True,
        fix_endpoints=not args.free_endpoints, device=args.device)
    t0 = time.perf_counter()
    edge_pred, (lo, hi) = tracer()
    dt = time.perf_counter() - t0

    res = tracer.last_result
    cred_px = _numpy(res.cred_interval_px)
    np.savez(args.out, edge_trace=edge_pred, cred_lower=lo, cred_upper=hi,
             y_mean=_numpy(res.y_mean), cred_px=cred_px,
             n_iters=int(res.n_iters), theta=np.exp(_numpy(res.theta)))
    print(json.dumps({"out": args.out, "n_iters": int(res.n_iters),
                      "converged": bool(res.converged),
                      "wall_s": round(dt, 3),
                      "lml": round(float(res.lml), 3)}))
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.imshow(_numpy(grad), cmap="gray")
        ax.plot(edge_pred[:, 1], edge_pred[:, 0], "r-", lw=1.5)
        ax.fill_between(edge_pred[:, 1], cred_px[0], cred_px[1], color="m",
                        alpha=0.3)
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}", file=sys.stderr)


def cmd_batch(args):
    """Trace every image matching the glob in one loop over the frames
    (``trace_batch``), or as a warm-started sequence (``--sequence``: each
    frame seeds the next frame's observations, gpet.py:57-61)."""
    import glob as globmod
    import os

    import torch

    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, trace_batch, trace_sequence)
    from gaussian_process_edge_trace_torch.trace.driver import make_config

    paths = sorted(globmod.glob(args.images))
    if not paths:
        raise SystemExit(f"no files match {args.images!r}")
    grads = [_grad_of(_load_image(p), args, gpt) for p in paths]
    shapes = {tuple(g.shape) for g in grads}
    if len(shapes) != 1:
        raise SystemExit(f"images must share one shape, got {shapes}")
    grads = torch.stack(grads)
    init = np.asarray([_parse_xy(args.init[0]), _parse_xy(args.init[1])])
    inits = np.broadcast_to(init, (len(paths),) + init.shape)
    cfg = make_config(
        init, tuple(grads.shape[1:]), kernel_options=_kernel_options(args),
        noise_y=args.noise_y, N_samples=args.n_samples,
        score_thresh=args.score_thresh, delta_x=args.delta_x,
        keep_ratio=args.keep_ratio, pixel_thresh=args.pixel_thresh,
        seed=args.seed, fix_endpoints=not args.free_endpoints)

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    if args.sequence:
        results = trace_sequence(cfg, grads, inits)
        per_frame = [(_numpy(r.edge_trace), int(r.n_iters),
                      bool(r.converged)) for r in results]
    else:
        data = make_batch_data(cfg, grads, inits)
        states = make_batch_state(cfg, len(paths), grads.device)
        res = trace_batch(cfg, data, states)
        edges = _numpy(res.edge_trace)
        per_frame = [(edges[f], int(res.n_iters[f]), bool(res.converged[f]))
                     for f in range(len(paths))]
    dt = time.perf_counter() - t0

    for p, (trace, n_it, conv) in zip(paths, per_frame):
        out = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(p))[0] + "_trace.npz")
        np.savez(out, edge_trace=trace)
        print(json.dumps({"image": p, "out": out, "n_iters": n_it,
                          "converged": conv}))
    print(json.dumps({"frames": len(paths), "wall_s": round(dt, 3),
                      "mode": "sequence" if args.sequence else "batch"}))


def cmd_demo(args):
    raise SystemExit("use: python -m "
                     "gaussian_process_edge_trace_torch.examples.demo")


def _tracer_flags(p):
    p.add_argument("--is-gradient", action="store_true",
                   help="input is already a gradient image")
    p.add_argument("--grad-kernel", type=int, nargs=2, default=[11, 5])
    p.add_argument("--kernel", choices=["RBF", "Matern"], default="RBF")
    p.add_argument("--sigma-f", type=float, required=True)
    p.add_argument("--length-scale", type=float, required=True)
    p.add_argument("--nu", type=float, default=2.5)
    p.add_argument("--noise-y", type=float, default=1.0)
    p.add_argument("--n-samples", type=int, default=1000)
    p.add_argument("--score-thresh", type=float, default=1.0)
    p.add_argument("--delta-x", type=int, default=5)
    p.add_argument("--keep-ratio", type=float, default=0.1)
    p.add_argument("--pixel-thresh", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--free-endpoints", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the trace runs: cuda (default) or cpu")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gaussian_process_edge_trace_torch",
        description="Trace edges by Gaussian-process regression on an "
                    "NVIDIA GPU (or the CPU with --device cpu).",
        epilog="The JAX CLI's --compilation-cache has no counterpart here: "
               "nothing is compiled per call, and the CUDA kernels build "
               "once into build/gpet_torch_kernels/, named by a digest of "
               "their sources.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trace", help="trace one edge in an image")
    t.add_argument("image", help=".npy or image file")
    t.add_argument("--init", nargs=2, required=True, metavar="X,Y",
                   help="two edge endpoints in xy, e.g. --init 0,250 499,250")
    _tracer_flags(t)
    t.add_argument("--out", default="trace_result.npz")
    t.add_argument("--plot", default=None,
                   help="write a figure of the trace here (needs matplotlib)")
    t.set_defaults(fn=cmd_trace)

    b = sub.add_parser(
        "batch", help="trace a glob of same-shaped images in one loop, or "
                      "a warm-started sequence with --sequence")
    b.add_argument("images", help="glob of .npy/image files, e.g. "
                                  "'frames/*.npy' (quote it)")
    b.add_argument("--init", nargs=2, required=True, metavar="X,Y",
                   help="shared edge endpoints in xy")
    b.add_argument("--sequence", action="store_true",
                   help="warm-start each frame from the previous frame's "
                        "accepted observations")
    _tracer_flags(b)
    b.add_argument("--out-dir", default="traces")
    b.set_defaults(fn=cmd_batch)

    d = sub.add_parser("demo", help="pointer to the examples' demo")
    d.set_defaults(fn=cmd_demo)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
