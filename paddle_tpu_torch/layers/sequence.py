"""``padding_mask``, ``sequence_length`` and the pooling layers
``sequence_pool``, ``sequence_first_step``, ``sequence_last_step``
(counterpart of ``paddle_tpu/layers/sequence.py``; the other sequence
layers come with later slices).  A padded sequence var's lengths are its
``<name>@LEN`` companion (``layers.data(lod_level=1)``)."""

from ..layer_helper import LayerHelper

__all__ = ["padding_mask", "sequence_length", "sequence_pool",
           "sequence_first_step", "sequence_last_step"]


def sequence_length(x, block=None):
    """The companion length Variable of a padded sequence var."""
    name = getattr(x, "_seq_len_name", None)
    if name is None:
        raise ValueError(
            "variable %r has no sequence-length companion; create it with "
            "layers.data(lod_level=1) or pass length= explicitly" % x.name)
    blk = block if block is not None else x.block
    return blk._find_var_recursive(name)


def sequence_pool(input, pool_type, length=None):
    """Pool each row of a padded sequence over its length: ``pool_type``
    one of average, sum, sqrt, max, last, first."""
    helper = LayerHelper("sequence_pool", input=input)
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    max_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input],
                "Length": [length if length is not None
                           else sequence_length(input)]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()})
    out._seq_len_name = None  # the time axis is pooled away
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


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
