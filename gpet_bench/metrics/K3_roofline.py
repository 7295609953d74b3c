"""K3 (``csrc/binning_2l_kernel.cu``): the frozen ``work_binning`` bound
at the kept curves (S_keep = N_keep), at each iteration for the frames
still active, over K3's profiled device time, in percent."""

from gpet_bench import work
from gpet_bench.metrics._common import active_frames, roofline_pct


def read(record):
    z = record["sizes"]
    return roofline_pct(
        record, ("binning_2l_kernel",),
        lambda req, k: work.work_binning(z["E"], z["N_keep"], z["M"],
                                         B=active_frames(req, k)))
