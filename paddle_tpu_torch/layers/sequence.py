"""``padding_mask`` (counterpart of ``paddle_tpu/layers/sequence.py``;
the other sequence layers come with later slices)."""

from ..layer_helper import LayerHelper

__all__ = ["padding_mask"]


def padding_mask(length, ref, dtype="float32", name=None):
    """[B] lengths -> [B, T] 0/1 mask, T from ``ref``'s time axis."""
    helper = LayerHelper("padding_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="padding_mask", inputs={"Length": [length], "Ref": [ref]},
        outputs={"Out": [out]}, attrs={"dtype": dtype})
    out.stop_gradient = True
    out._seq_len_name = None
    return out
