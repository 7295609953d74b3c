"""Tracing over several devices: frames data-parallel and each iteration's
posterior samples sample-parallel over a (data, sample) mesh.

One process per rank, started here with ``torch.multiprocessing.spawn``
and joined through a ``tcp://localhost`` rendezvous: NCCL on the cards
(``--device cuda``, one card per rank; a mesh larger than the cards present
is refused), gloo on the CPU (``--device cpu``). Every posterior draw is
keyed by its global sample index, so the sharded result is the
single-device batch's, frame for frame; rank 0 checks that against
``trace_batch`` and prints each frame.

Run: ``python -m gaussian_process_edge_trace_torch.examples.multichip
[--mesh 1,1] [--frames 4] [--device cuda]``.
"""

import argparse
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _problem(frames, size, n_sample):
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.trace.driver import make_config

    M = N = size
    grads, inits, edges = [], [], []
    for f in range(frames):
        img, edge = gpt.construct_test_img(
            size=(M, N), amplitude=M // 3, curvature=2, noise_level=0.02,
            ltype="sinusoidal", intensity=0.3, gaps=False, seed=f + 1)
        grads.append(gpt.comp_grad_img(img, gpt.kernel_builder((7, 3)),
                                       device="cpu"))
        inits.append([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
        edges.append(edge[:N])
    cfg = make_config(
        np.asarray(inits[0]), (M, N),
        kernel_options={"kernel": "RBF", "sigma_f": M // 4,
                        "length_scale": N // 12},
        noise_y=1, N_samples=128 * n_sample, score_thresh=0.5, delta_x=6,
        keep_ratio=0.1, pixel_thresh=4, seed=1, fix_endpoints=True)
    return cfg, torch.stack(grads), np.asarray(inits), edges


def _rank(rank, world, port, args, n_data, n_sample):
    import gaussian_process_edge_trace_torch as gpt
    from gaussian_process_edge_trace_torch.parallel import (
        make_batch_data, make_batch_state, make_mesh, sharded_trace_batch,
        trace_batch)

    torch.set_num_threads(1)
    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        cfg, grads, inits, edges = _problem(args.frames, args.size, n_sample)
        mesh = make_mesh(n_data, n_sample, dev.type)
        data = make_batch_data(cfg, grads.to(dev), inits, dev)
        res = sharded_trace_batch(cfg, data,
                                  make_batch_state(cfg, args.frames, dev),
                                  mesh, args.frames)
        if rank == 0:
            print(f"mesh: {tuple(mesh.shape)} over {world} {dev.type} "
                  f"rank(s)")
            want = trace_batch(cfg, data,
                               make_batch_state(cfg, args.frames, dev))
            same = torch.equal(res.edge_trace, want.edge_trace)
            for f in range(args.frames):
                mse = float(gpt.trace_MSE(res.edge_trace[f], edges[f]))
                print(f"frame {f}: converged={bool(res.converged[f])} "
                      f"iters={int(res.n_iters[f])} MSE={mse:.2f}")
            print(f"equal to the single-device trace_batch: {same}")
            if not same:
                raise SystemExit("the sharded batch differs from "
                                 "trace_batch")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,1",
                    help="data,sample mesh shape (product = ranks)")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    n_data, n_sample = (int(v) for v in args.mesh.split(","))
    world = n_data * n_sample
    if args.frames % n_data:
        raise SystemExit(f"--frames {args.frames} must divide over "
                         f"{n_data} data ranks")
    if args.device == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise SystemExit(f"a {n_data}x{n_sample} mesh needs {world} "
                             f"cards, {cards} present (NCCL takes one rank "
                             "per card); use --device cpu for a gloo mesh")
    mp.spawn(_rank, args=(world, _free_port(), args, n_data, n_sample),
             nprocs=world, join=True)


if __name__ == "__main__":
    main()
