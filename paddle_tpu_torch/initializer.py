"""Parameter initializers: emit init ops into the startup program
(counterpart of ``paddle_tpu/initializer.py``).  The ops and their attrs
are the JAX package's, so the startup programs serialize alike; the port
draws the numbers from a ``torch.Generator`` (see ``ops/creation.py``),
which is a different stream than JAX's threefry — tests carry weights
across with ``convert.load_numpy_params`` instead of re-drawing them."""

import math

import numpy as np

from .core import dtype_name

__all__ = [
    "Initializer", "ConstantInitializer", "UniformInitializer",
    "NormalInitializer", "TruncatedNormalInitializer", "XavierInitializer",
    "NumpyArrayInitializer",
]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fan_in_out(var):
        shape = var.shape
        if len(shape) < 2:
            return (shape[0] if shape else 1,) * 2
        receptive = 1
        for s in shape[2:]:
            receptive *= s
        return shape[0] * receptive, shape[1] * receptive


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "value": self.value,
                   "dtype": dtype_name(var.dtype)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "min": self.low,
                   "max": self.high, "dtype": dtype_name(var.dtype),
                   "seed": self.seed},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "dtype": dtype_name(var.dtype),
                   "seed": self.seed},
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "mean": self.loc,
                   "std": self.scale, "dtype": dtype_name(var.dtype),
                   "seed": self.seed},
        )


class XavierInitializer(Initializer):
    """Glorot init."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    """Fixed values (the Transformer's sinusoid position tables), carried
    in the ``assign_value`` op's attrs."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        dtype = dtype_name(var.dtype)
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={"shape": list(self.value.shape), "dtype": dtype,
                   "values": self.value.astype(dtype).reshape(-1).tolist()},
        )
