"""The yardstick's frozen copies against what they were copied from, the
bounds and the FLOP count on hand-worked shapes, and what the harness
imports."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from gpet_bench import inputs, threefry, work
from gpet_bench.tests.tiny import BENCH_DIR, REPO

PORT = "gaussian_process_edge_trace_torch"
# Modules of the reference side: they may import nothing of the program.
REFERENCE_SIDE = ("reference", "threefry", "check", "inputs", "work")


def test_k1_bound_at_1000_with_the_copy():
    # chip_smoke.py's kernel table: 0.0251 ms at E = M = 1000, S = 10^4.
    t, kind = work.bound(*work.work_k1(1000, 1000, 10_000, True))
    assert kind == "bytes"
    assert round(t * 1e3, 4) == 0.0251
    t, _ = work.bound(*work.work_k1(500, 500, 1000, False))
    assert round(t * 1e3, 5) == 0.00090


def test_trace_flops_on_a_hand_worked_shape():
    sizes = {"E": 2, "M": 3, "N": 4, "S": 5, "N_keep": 1, "r": 2,
             "n_inits": 2, "n_train": 8}
    # Iteration 0 at n = 2: sampling 28 + 2 + 8/3 + 80 + 20 + 30 + 40 + 28
    # + 40 + 40, costs 230, weights 2, binning 20, blur 68·5·6 = 2040,
    # min-max 24, scores 48.
    it0 = 28 + 2 + 8 / 3 + 80 + 20 + 30 + 40 + 28 + 40 + 40 + 230 + 2 + 20 \
        + 2040 + 24 + 48
    # Final fit at n = 3: an LML value 63 + 9 + 9 + 9 = 90, with its
    # gradient 90 + 9 + 18 + 18 + 36 + 54 = 225; 109 starts screened, 4
    # steps of 8 points of 7 gradients and 6 values; the fit 63 + 9 + 18,
    # the prediction 42 + 12 + 18 + 12 + 2, interval 12, final cost 46.
    fit = 109 * 90 + 4 * 8 * (7 * 225 + 6 * 90) + 90 + 86 + 12 + 46
    assert work.trace_flops(sizes, 1, [1]) == pytest.approx(it0 + fit)


def test_final_fit_goes_coarse_to_fine_above_160_slots():
    direct = work.final_fit_flops(1000, 150, 160)
    coarse = work.final_fit_flops(1000, 150, 208)
    stride = 2   # ceil(208 / 112)
    assert coarse - direct == pytest.approx(
        work.polish_flops(75, 109, 8, 4) + work.polish_flops(150, 2, 2, 3)
        - work.polish_flops(150, 109, 8, 4))
    assert -(-208 // 112) == stride


def test_generator_and_gradient_equal_the_programs():
    import gaussian_process_edge_trace_torch as gpt
    conf = json.loads((BENCH_DIR / "configs/demo500.json").read_text())
    conf["image"]["size"] = [64, 80]
    conf["image"]["amplitude"] = 20
    for seed in (1, 2 ** 31 - 1):
        grad, edge = inputs.make_image(conf, seed, "cpu")
        img, edge2 = gpt.construct_test_img((64, 80), 20, 4, 0.05,
                                            "sinusoidal", 0.3, gaps=True,
                                            seed=seed)
        grad2 = gpt.comp_grad_img(img, gpt.kernel_builder((11, 5)),
                                  device="cpu")
        assert np.array_equal(edge, edge2)
        assert torch.equal(grad, grad2)


def test_dice_equals_the_programs():
    import gaussian_process_edge_trace_torch as gpt
    rng = np.random.RandomState(3)
    truth = np.stack([rng.randint(0, 90, 100), np.arange(100)], 1)
    preds = np.stack([truth + np.stack([rng.randint(-w, w + 1, 100),
                                        np.zeros(100, int)], 1)
                      for w in (3, 3, 3, 150, 150, 150)])
    assert inputs.dice_many(preds, truth) == [
        gpt.trace_dicecoef(p, truth) for p in preds]


def test_threefry_copy_equals_the_programs_draws():
    from gaussian_process_edge_trace_torch.ops import prng
    for seed in (0, 7, 2 ** 31 + 5, 2 ** 40 + 3):
        key = threefry.fold_in(threefry.prng_key(seed), 3)
        assert key == prng.fold_in(prng.prng_key(seed), 3)
        kp, kn = threefry.split(key)
        assert (kp, kn) == prng.split(key)
        assert torch.equal(threefry.normal(kp, (6, 33), "cpu"),
                           prng.normal_plain(kp, (6, 33)))
        assert torch.equal(threefry.uniform(kn, (12, 3), "cpu"),
                           prng.uniform_plain(kn, (12, 3)))


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}, names


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for path in BENCH_DIR.rglob("*.py"):
        top, full = _imports(path)
        assert not top & {"jax", "jaxlib", "flax",
                          "gaussian_process_edge_trace_tpu", "benchmarks",
                          "bench"}, path
        if path.parent == BENCH_DIR and path.stem in REFERENCE_SIDE:
            assert PORT not in top, path
            assert all(n.split(".")[0] == "gpet_bench" or
                       n.split(".")[0] in {"numpy", "torch", "math",
                                           "hashlib", "functools", "typing",
                                           "__future__"} for n in full), path


def test_a_run_loads_no_jax_and_no_old_benchmark(tmp_path):
    """A whole run of a tiny cell on the CPU in a process of its own:
    afterwards no loaded module has the top-level name of JAX, of the JAX
    package or of the old benchmark, compared whole."""
    script = textwrap.dedent(f"""
        import json, sys
        from pathlib import Path
        sys.path.insert(0, {str(REPO)!r})
        from gpet_bench import harness
        from gpet_bench.tests.tiny import tiny_root
        root, bench = tiny_root(Path({str(tmp_path)!r}))
        line = harness.run(bench, "tiny.single", 5, 0.3, False,
                           device="cpu", root=root, log=lambda m: None)
        top = {{m.split(".")[0] for m in sys.modules}}
        print(json.dumps({{"correct": line["correct"],
                          "bad": sorted(top & {{"jax", "jaxlib", "flax",
                              "gaussian_process_edge_trace_tpu",
                              "benchmarks", "bench"}}),
                          "forbidden": harness.forbidden_modules()}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": [], "forbidden": []}


def test_the_reference_side_loads_nothing_of_the_program():
    mods = ", ".join(f"gpet_bench.{m}" for m in REFERENCE_SIDE)
    script = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
              f"import {mods}; "
              f"print(sorted(m for m in sys.modules "
              f"if m.split('.')[0] == {PORT!r}))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
