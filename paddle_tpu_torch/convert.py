"""Carry state into the port's scope from numpy arrays.

Variable names are explicit and identical in the JAX package's and the
port's programs, and the layouts are the JAX package's (``fc`` weights are
[in, out] for ``x @ W``), so a checkpoint maps name to name with nothing
transposed.  ``load_numpy_params`` copies whatever it is given;
``load_numpy_state`` copies every persistable variable of a program
(parameters, optimizer moments and beta powers, learning-rate and
step-counter vars, fixed tables) and refuses to leave one out."""

import numpy as np
import torch

__all__ = ["load_numpy_params", "load_numpy_state"]


def load_numpy_params(scope, params, device):
    """Copy ``{name: np.ndarray}`` into ``scope`` as tensors on
    ``device``; returns the number of variables set."""
    device = torch.device(device)
    for name, arr in params.items():
        scope.set_var(name, torch.from_numpy(
            np.array(arr, copy=True)).to(device))
    return len(params)


def load_numpy_state(scope, program, arrays, device):
    """Copy every persistable variable of ``program`` (typically the
    startup program) from ``arrays`` (``{name: np.ndarray}``, e.g. read
    from a JAX scope after its startup run) into ``scope`` on ``device``,
    each in the dtype the program declares (the JAX package holds int64
    values as int32).  Raises KeyError naming any persistable variable
    that ``arrays`` lacks; returns the number of variables set."""
    device = torch.device(device)
    wanted = {v.name: v for v in program.list_vars() if v.persistable}
    missing = sorted(n for n in wanted if n not in arrays)
    if missing:
        raise KeyError("no value for persistable variables %s" % missing)
    for name, var in wanted.items():
        scope.set_var(name, torch.from_numpy(
            np.array(arrays[name], copy=True)).to(device=device,
                                                  dtype=var.dtype))
    return len(wanted)
