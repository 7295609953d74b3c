"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels' build or load, the pool and one warm-up request."""


def read(record):
    return record["setup_s"]
