"""K7 (``csrc/threefry_normal_kernel.cu``): the bound of ``work_k7k8``
(bytes, operations and instructions at the issue rate) of one iteration's
table, the (r, S) prior and (n_train, S) noise normals that every frame of
a request draws alike, for each loop iteration, over the device time of the
K7 kernels that ran in the loop's iterations, in percent. None where the
loop's iterations cannot be told on the device (``_device.py``)."""

from gpet_bench import work_k7k8
from gpet_bench.metrics._device import roofline_pct


def read(record):
    z = record["sizes"]
    per_iter = work_k7k8.iteration_table_s(z["r"], z["n_train"], z["S"])
    return roofline_pct(record, ("threefry_table_kernel",),
                        lambda req, k, frames: per_iter)
