"""Device kernels launched per loop iteration: the kernel events of the
profiled requests over their loop iterations (a batch's loop steps all of
its frames at once)."""

from gpet_bench.metrics._common import loop_iterations


def read(record):
    prof = record.get("profile")
    if not prof:
        return None
    iters = sum(loop_iterations(r) for r in prof["requests"])
    return len(prof["timeline"].kernels()) / iters
