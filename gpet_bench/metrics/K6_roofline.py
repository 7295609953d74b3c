"""K6 (``csrc/batched_trsm_kernel.cu``) in the sampling round: the frozen
``work_k6`` bound of the forward and the backward solve with m = S right-
hand sides, each one launch for the frames active at the iteration, at
each frame's valid training points (not the padded buffer the kernel
runs), over the device time of the K6 kernels that ran in the loop's
iterations (the sampling round's solves are the loop's only K6 launches;
the final fit's are not counted), in percent. None where the loop's
iterations cannot be told on the device (``_device.py``)."""

from gpet_bench import work
from gpet_bench.metrics._device import frame_nobs, roofline_pct


def read(record):
    z = record["sizes"]

    def least(req, k, frames):
        parts = [work.work_k6(1, frame_nobs(req, f, k, z["n_inits"]),
                              z["S"]) for f in frames]
        return 2 * work.bound(sum(b for b, _ in parts),
                              sum(o for _, o in parts))[0]
    return roofline_pct(record, ("batched_trsm_kernel", "batched_trsv_kernel"),
                        least)
