"""The entry point's constructor (``GP_Edge_Tracing.__init__``): host
clock around it, ending in a synchronise, median over the traced run's
requests, in ms."""

import numpy as np


def read(record):
    t = [r["construct_s"] for r in record["requests"]
         if r["construct_s"] is not None]
    return float(np.median(t)) * 1e3 if t else None
