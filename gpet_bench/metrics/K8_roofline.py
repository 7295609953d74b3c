"""K8 (``csrc/frames_product_kernel.cu``) in the loop: the bound of
``work_k7k8.work_k8`` for each launch of a loop iteration at its own
shape, over the device time of the K8 kernels that ran in the loop's
iterations, in percent.
Each iteration launches the posterior's cross product, (E, n) @ (n, S) for
every active frame at its valid training points, and for each axis of the
(M + 2, N + 2) KDE grid that blurs as a matmul (up to 600 long) one product
with that axis's shared banded factor (band 8): the program's rule
(``trace/kde.py``'s ``_BLUR_MATMUL_MAX`` and ``DEFAULT_RADIUS``, which a
test holds these constants to). None where the loop's iterations cannot be
told on the device (``_device.py``)."""

from gpet_bench import work
from gpet_bench.metrics._device import frame_nobs, roofline_pct
from gpet_bench.work_k7k8 import bound_k8, work_k8

BLUR_MATMUL_MAX = 600
BAND = 8


def read(record):
    z = record["sizes"]
    Mp, Np = z["M"] + 2, z["N"] + 2

    def least(req, k, frames):
        parts = [work_k8(1, z["E"], z["S"],
                         frame_nobs(req, f, k, z["n_inits"]))
                 for f in frames]
        t = work.bound(sum(b for b, _ in parts), sum(o for _, o in parts))[0]
        B = len(frames)
        if Mp <= BLUR_MATMUL_MAX:
            t += bound_k8(B, Mp, Np, Mp, a_shared=True, band=BAND)
        if Np <= BLUR_MATMUL_MAX:
            t += bound_k8(B, Mp, Np, Np, b_shared=True, band=BAND)
        return t
    return roofline_pct(record, ("frames_product_kernel",), least)
