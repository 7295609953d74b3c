"""The median DICE against the true edge over every trace of the window
(each pool image traced at least once)."""

import numpy as np


def read(record):
    return float(np.median(record["dice"]))
