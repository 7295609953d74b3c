"""The whole trace's share of the card's float32 peak: the algorithm's
float32 operations (``work.trace_flops``) over every trace of the traced
run's window, over the window's request walls (run without the profiler)
times 67 TFLOP/s, in percent. TF32 is off in the program."""

from gpet_bench import work


def read(record):
    z = record["sizes"]
    flops = sum(work.trace_flops(z, n, nobs) for r in record["requests"]
                for n, nobs in zip(r["n_iters"], r["iter_nobs"]))
    wall = sum(r["wall_s"] for r in record["requests"])
    return 100.0 * flops / (wall * work.F32_OPS_PER_S)
