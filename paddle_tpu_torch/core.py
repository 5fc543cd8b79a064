"""Variable kinds and the dtype map of the PyTorch port.

Counterpart of ``paddle_tpu/core.py``.  A program declares dtypes by their
numpy-style names ("float32", "int64", ...); the port materializes them as
``torch.dtype`` values.  Unlike the JAX package there is no x64 switch:
int64 token ids stay int64 (PyTorch indexes with int64 natively).  The
serialized program schema keeps the names, so programs built by either
package serialize identically (``framework.Program.to_dict``).
"""

import numpy as np
import torch

__all__ = ["VarType", "convert_dtype", "dtype_name"]


class VarType:
    """Variable kinds (the names the JAX package serializes)."""

    DENSE_TENSOR = "dense_tensor"
    SELECTED_ROWS = "selected_rows"
    READER = "reader"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    "int64": torch.int64,
    "int16": torch.int16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def convert_dtype(dtype):
    """Normalize a dtype given as a name, a numpy dtype or a torch dtype
    to a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError("unsupported dtype: %r" % (dtype,))
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError("unsupported dtype: %r" % (dtype,))
    return _DTYPES[name]


def dtype_name(dtype):
    """The serialized name of a dtype ("float32", "int64", ...)."""
    return _NAMES[convert_dtype(dtype)]

