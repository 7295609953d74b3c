"""Gaussian-process models: kernels, regression and the LML polish."""
