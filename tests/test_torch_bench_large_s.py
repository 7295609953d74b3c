"""PyTorch port against the benchmark's plain reference (``gpet_bench/
reference.py``) on the large-S path, on the CPU: the small config (64×96)
traced through ``GP_Edge_Tracing(...)()`` at S = 2·10⁴, above K1's
transposed-copy threshold of 8192, with its KDE binning 2000 kept curves,
and at S = 1000 below it; each compared as the benchmark's check compares a
trace (``gpet_bench.check.compare``) and held to the limits of the 1000²
S = 10⁵ cell."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import gaussian_process_edge_trace_torch as gpt
from gaussian_process_edge_trace_torch.ops import cuda_interp as ci
from gpet_bench import check, reference
from torch_parity import SMALL_IMG, SMALL_KW, small_problem

REPO = Path(__file__).resolve().parent.parent
LIMITS = json.loads(
    (REPO / "gpet_bench/limits/suite1000_S1e5.single.json").read_text())


@pytest.mark.parametrize("S", [20000, 1000])
def test_trace_within_the_large_s_cell_limits(S):
    _, _, grad, init = small_problem(SMALL_IMG)
    tr = {k: v for k, v in SMALL_KW.items() if k != "seed"}
    tr.update(N_samples=S, return_std=True)
    seed = SMALL_KW["seed"]
    tracer = gpt.GP_Edge_Tracing(
        init, grad, tr["kernel_options"], tr["noise_y"], np.array([]), S,
        tr["score_thresh"], tr["delta_x"], tr["keep_ratio"],
        tr["pixel_thresh"], seed, True, tr["fix_endpoints"], device="cpu")
    edge, cred = tracer()
    res = tracer.last_result
    assert (S >= ci._TRANSPOSE_MIN_S) == (S == 20000)
    ref = reference.Reference(torch.tensor(grad), init, tr)
    assert ref.p.N_keep == S // 10
    nums = check.compare(ref, check.from_result(res, edge, np.stack(cred)),
                         seed)
    assert res.n_iters >= 2
    assert check.judge(nums, LIMITS), (nums, LIMITS)
    assert nums["edge_off"] == 0 and nums["parted_share"] == 0
