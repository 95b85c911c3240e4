"""Bayesian DLA detection in quasar spectra, in JAX.

A ground-up JAX/XLA rebuild of the Garnett/Ho Gaussian-process DLA
detection pipeline (see README.md).
"""

from .params import CIVParameters, Parameters, ZParameters

__version__ = "0.1.0"

__all__ = [
    "Parameters",
    "ZParameters",
    "CIVParameters",
    "__version__",
]
