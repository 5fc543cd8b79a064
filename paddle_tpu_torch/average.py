"""Python-side weighted averaging (counterpart of
``paddle_tpu/average.py``, copied: that module imports no JAX, but the
package around it does).  ``WeightedAverage`` is deprecated in favour of
the metrics and kept for the API."""

import warnings

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_(var):
    return isinstance(var, (int, float)) or (
        isinstance(var, np.ndarray) and var.shape == (1,))


def _is_number_or_matrix_(var):
    return _is_number_(var) or isinstance(var, np.ndarray)


class WeightedAverage(object):
    """Accumulate value*weight / weight."""

    def __init__(self):
        warnings.warn(
            "The %s is deprecated, please use fluid.metrics.Accuracy "
            "instead." % self.__class__.__name__, Warning)
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix_(value):
            raise ValueError("The 'value' must be a number(int, float) "
                             "or a numpy ndarray.")
        if not _is_number_(weight):
            raise ValueError("The 'weight' must be a number(int, float).")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
