"""K1 (``csrc/fused_cost_kernel.cu``, its partial and reduce kernels):
the frozen ``work_k1`` bound, at each iteration for the frames still
active, with the transposed copy from S = 8192 up, over K1's profiled
device time, in percent. None where K1 never ran (odd E)."""

from gpet_bench import work
from gpet_bench.metrics._common import active_frames, roofline_pct


def read(record):
    z = record["sizes"]
    return roofline_pct(
        record, ("fused_cost_partial_kernel", "fused_cost_reduce_kernel"),
        lambda req, k: work.work_k1(z["E"], z["M"], z["S"], z["S"] >= 8192,
                                    B=active_frames(req, k)))
