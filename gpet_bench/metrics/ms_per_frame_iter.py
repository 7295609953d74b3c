"""The serving layer (``parallel.trace_batch``): the traced run's batch
walls over the sum over frames of their iterations, in ms. It rises with
lockstep stragglers (finished frames stepped on) and per-frame calls."""


def read(record):
    if record["entry"] != "batch":
        return None
    iters = sum(sum(r["n_iters"]) for r in record["requests"])
    return 1e3 * sum(r["wall_s"] for r in record["requests"]) / iters
