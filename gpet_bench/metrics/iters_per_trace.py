"""The host loop's iterations per trace (``TraceResult.n_iters``), the mean
over every trace of the traced run's window."""


def read(record):
    n = [v for r in record["requests"] for v in r["n_iters"]]
    return sum(n) / len(n)
