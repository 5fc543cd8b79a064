"""``data``: a feedable program input (counterpart of
``paddle_tpu/layers/io.py:data``).  ``lod_level >= 1`` declares a padded
sequence [batch, time, *shape] plus its int32 [batch] length companion
``<name>@LEN``."""

from ..core import VarType
from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=VarType.DENSE_TENSOR, stop_gradient=True):
    block = default_main_program().current_block()
    shape = list(shape)
    if lod_level >= 1:
        shape = [-1, -1] + shape
    elif append_batch_size:
        shape = [-1] + shape
    var = block.create_var(name=name, shape=shape, dtype=dtype, type=type,
                           stop_gradient=stop_gradient, lod_level=lod_level,
                           is_data=True)
    if lod_level >= 1:
        len_var = block.create_var(name=name + "@LEN", shape=[-1],
                                   dtype="int32", stop_gradient=True,
                                   is_data=True)
        var._seq_len_name = len_var.name
    return var
