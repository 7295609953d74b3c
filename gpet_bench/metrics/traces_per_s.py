"""Traces completed in the window over the window's length; each frame of
a batch is one trace."""


def read(record):
    return sum(len(r["n_iters"]) for r in record["requests"]) / \
        record["window_s"]
