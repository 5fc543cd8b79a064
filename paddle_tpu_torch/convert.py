"""Carry weights into the port's scope from numpy arrays.

Parameter names are explicit and identical in the JAX package's and the
port's, and the layouts are the JAX package's (``fc`` weights are
[in, out] for ``x @ W``), so a checkpoint maps name to name with nothing
transposed."""

import numpy as np
import torch

__all__ = ["load_numpy_params"]


def load_numpy_params(scope, params, device):
    """Copy ``{name: np.ndarray}`` into ``scope`` as tensors on
    ``device``; returns the number of variables set."""
    device = torch.device(device)
    for name, arr in params.items():
        scope.set_var(name, torch.from_numpy(
            np.array(arr, copy=True)).to(device))
    return len(params)
