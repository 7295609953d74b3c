"""Single traces of the port through ``GP_Edge_Tracing(...)()`` on a CUDA
card, in the configurations of ``chip_smoke.py``: their warm wall time, or
their DICE over many image and tracer seeds.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 tests/torch_single_traces.py walls [--runs 7] [--label NAME]
    python3 tests/torch_single_traces.py dice [--images 1 2 3 4] \\
        [--seeds 1 2 ... 10] [--right-end 999 998]
    python3 tests/torch_single_traces.py results --save FILE
    python3 tests/torch_single_traces.py results --compare FILE_A FILE_B

``walls`` times one trace of each of the demo config, the 1000² S=10⁴
config at E = 1000 and at E = 999 (image seed 1, tracer seed 1): the host
clock of ``tracer()`` ending in a synchronise, after one warm-up trace, the
median and every run; then, in runs of their own, the loop
(``driver.run_loop``) and the final fit (``driver.finish_trace``) apart;
then, in one ``torch.profiler`` run each, the device operations (kernels,
copies, fills) that one trace and one final fit launch, a count the host's
noise does not move.
The package is imported from the Python path, so two trees are timed
against each other on one card by running this script with ``PYTHONPATH``
set to each, interleaved (A, B, B, A); it uses only the tracer and those
two driver functions.

``dice`` traces the 1000² S=10⁴ config for every image seed, tracer seed
and right endpoint (999: E = 1000, K1 scores; 998: E = 999, K2 scores) and
reports DICE and MSE against the true edge, with the least, median and
largest DICE per image and endpoint: the port's spread on the card, beside
the JAX package's on a CPU from ``tests/torch_reference_1000.py
--image-seed K --reference-only ...``. The port's default draws are the
JAX package's stream (``trace/driver.py::StreamDraws``), so a tracer seed
draws here what it draws there.

``results --save`` keeps every ``TraceResult`` field of the demo config's
traces at E = 500 and 499 (tracer seeds 1-3) and of the 1000² config's at
E = 1000 (seed 1) and 999 (seeds 1-3), image seed 1, in ``FILE``;
``results --compare`` (no card needed) names, for each trace of two such
files (two trees, each run with ``PYTHONPATH`` set to it), the fields that
differ in any bit, with the largest absolute difference of each float
field and that over its largest magnitude.

Each mode prints one line per trace and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np

# The package from the Python path if it is there (another tree, to time it
# against this one), else this tree's.
sys.path.append(str(pathlib.Path(__file__).resolve().parents[1]))

# (image size, edge amplitude, kernel options, samples): chip_smoke.py's
# demo_config and big_config.
DEMO = ((500, 500), 200, {"kernel": "RBF", "sigma_f": 75,
                          "length_scale": 20}, 1000)
BIG = ((1000, 1000), 400, {"kernel": "RBF", "sigma_f": 200,
                           "length_scale": 50}, 10000)


def make_tracer(gpt, config, right, image_seed, seed, dev):
    """(tracer, true edge over its E columns) for ``config`` with the right
    endpoint at column ``right`` of the true edge."""
    size, amplitude, ko, n_samples = config
    img, truth = gpt.construct_test_img(size, amplitude, 4, 0.05,
                                        "sinusoidal", 0.3, gaps=True,
                                        seed=image_seed)
    grad = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5), unit=False),
                             device=dev)
    init = truth[[0, right]][:, [1, 0]]
    E = int(init[1, 0] - init[0, 0]) + 1
    tracer = gpt.GP_Edge_Tracing(init, grad, ko, 1, np.array([]), n_samples,
                                 1, 5, 0.1, 5, seed, True, True, device=dev)
    return tracer, truth[:E]


def walls(args, gpt, torch, dev):
    from gaussian_process_edge_trace_torch.trace import driver as pd

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    def device_ops(fn):
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            clock(fn)
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)

    rows = {}
    for name, config, right in (("demo", DEMO, -1), ("1000_S1e4", BIG, -1),
                                ("1000_S1e4_oddE", BIG, -2)):
        tracer, truth = make_tracer(gpt, config, right, 1, 1, dev)
        edge, _ = tracer()                                  # warm-up
        runs = [clock(tracer)[0] for _ in range(args.runs)]
        cfg, data = tracer.cfg, tracer.data
        draws = pd.StreamDraws(cfg, data.L_prior_unit.shape[1], dev)
        loop, fit = [], []
        for _ in range(args.runs):
            ms, state = clock(lambda: pd.run_loop(
                cfg, data, pd.init_state(cfg, dev), draws))
            loop.append(ms)
            fit.append(clock(lambda: pd.finish_trace(cfg, data, state,
                                                     draws))[0])
        rows[name] = {"median_ms": statistics.median(runs), "runs_ms": runs,
                      "loop_median_ms": statistics.median(loop),
                      "fit_median_ms": statistics.median(fit),
                      "loop_ms": loop, "fit_ms": fit,
                      "trace_device_ops": device_ops(tracer),
                      "fit_device_ops": device_ops(lambda: pd.finish_trace(
                          cfg, data, state, draws)),
                      "dice": float(gpt.trace_dicecoef(edge, truth))}
        r = rows[name]
        print(f"[walls {args.label}] {name}: median {r['median_ms']:.2f} ms "
              f"over {args.runs} traces {[round(t, 2) for t in runs]}; loop "
              f"{r['loop_median_ms']:.2f} ms, final fit "
              f"{r['fit_median_ms']:.2f} ms (medians); device operations: "
              f"{r['trace_device_ops']} per trace, {r['fit_device_ops']} in "
              f"the final fit; DICE {r['dice']}", flush=True)
    return {"mode": "walls", "label": args.label, "configs": rows}


def dice(args, gpt, torch, dev):
    rows, summary = [], {}
    for right in args.right_end:
        for image in args.images:
            got = []
            for seed in args.seeds:
                tracer, truth = make_tracer(gpt, BIG, right, image, seed, dev)
                edge, _ = tracer()
                torch.cuda.synchronize()
                d = float(gpt.trace_dicecoef(edge, truth))
                m = float(gpt.trace_MSE(edge, truth))
                got.append(d)
                rows.append({"right_end": right, "image_seed": image,
                             "seed": seed, "E": len(truth), "dice": d,
                             "mse": m,
                             "n_iters": int(tracer.last_result.n_iters)})
                print(f"[dice] E={len(truth)} image seed {image} tracer seed "
                      f"{seed}: DICE {d} MSE {m} n_iters "
                      f"{rows[-1]['n_iters']}", flush=True)
            key = f"E={len(truth)} image {image}"
            summary[key] = {"min": min(got), "median": statistics.median(got),
                            "max": max(got)}
            print(f"[dice] {key}: DICE min {min(got)} median "
                  f"{statistics.median(got)} max {max(got)} over tracer seeds "
                  f"{args.seeds}", flush=True)
    return {"mode": "dice", "rows": rows, "summary": summary}


# results: (name, config, right endpoint column, tracer seeds).
RESULT_CASES = (("demo", DEMO, 499, (1, 2, 3)),
                ("demo_oddE", DEMO, 498, (1, 2, 3)),
                ("1000", BIG, 999, (1,)),
                ("1000_oddE", BIG, 998, (1, 2, 3)))


def results(args, gpt, torch, dev):
    """Every field of each ``RESULT_CASES`` trace, saved to ``args.save``."""
    out = {}
    for tag, config, right, seeds in RESULT_CASES:
        for seed in seeds:
            tracer, _ = make_tracer(gpt, config, right, 1, seed, dev)
            tracer()
            out[f"{tag} seed {seed}"] = {
                k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in tracer.last_result._asdict().items()}
            print(f"[results] {tag} seed {seed}: n_iters "
                  f"{out[f'{tag} seed {seed}']['n_iters']}", flush=True)
    torch.save(out, args.save)
    return {"mode": "results", "saved": args.save, "traces": list(out)}


def compare(path_a, path_b):
    """Per trace of two ``results`` files: the fields that differ in any
    bit, and each float field's largest absolute and relative gap."""
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    rows = {}
    for name in a:
        gaps = {}
        for f, x in a[name].items():
            y = b[name][f]
            if not isinstance(x, torch.Tensor):
                if x != y:
                    gaps[f] = None
                continue
            if x.is_floating_point():
                if x.shape != y.shape or not torch.equal(
                        x.view(ints[x.element_size()]),
                        y.view(ints[y.element_size()])):
                    d = (x.double() - y.double()).abs().max().item()
                    gaps[f] = {"max_abs": d, "max_rel": d / max(
                        y.double().abs().max().item(), 1e-30)}
            elif not torch.equal(x, y):
                gaps[f] = None
        rows[name] = gaps
        print(f"[compare] {name}: differs in {list(gaps)} {gaps}",
              flush=True)
    return {"mode": "compare", "files": [path_a, path_b], "rows": rows}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    w = sub.add_parser("walls")
    w.add_argument("--runs", type=int, default=7)
    w.add_argument("--label", default="")
    d = sub.add_parser("dice")
    d.add_argument("--images", type=int, nargs="+", default=[1, 2, 3, 4])
    d.add_argument("--seeds", type=int, nargs="+",
                   default=list(range(1, 11)))
    d.add_argument("--right-end", type=int, nargs="+", default=[999, 998])
    r = sub.add_parser("results")
    one = r.add_mutually_exclusive_group(required=True)
    one.add_argument("--save", metavar="FILE")
    one.add_argument("--compare", nargs=2, metavar="FILE")
    args = p.parse_args(argv)
    if args.mode == "results" and args.compare:
        print(json.dumps(compare(*args.compare)), flush=True)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("torch_single_traces: no CUDA device", file=sys.stderr)
        return 1
    import gaussian_process_edge_trace_torch as gpt
    dev = torch.device("cuda", 0)
    out = {"walls": walls, "dice": dice, "results": results}[args.mode](
        args, gpt, torch, dev)
    out["package"] = gpt.__file__
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
