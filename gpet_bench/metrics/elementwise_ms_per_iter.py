"""Device time of PyTorch's own kernels in the loop: ATen's elementwise,
reduce, sort, index and copy kernels (and the CUB it carries) that ran in
the loop's iterations of the profiled tail, over the number of
``gpet.iter`` spans, in ms. None where the loop's iterations cannot be
told on the device (``_device.py``)."""

from gpet_bench.metrics._device import iter_ms

TORCH_KERNELS = ("at::native::", "at_cuda_detail::")


def read(record):
    return iter_ms(record, lambda n, c: c == "kernel" and (
        n[5:] if n.startswith("void ") else n).startswith(TORCH_KERNELS))
