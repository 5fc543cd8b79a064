"""``padding_mask``, ``sequence_length``, the recurrent layers
``dynamic_lstm``, ``dynamic_lstmp``, ``dynamic_gru``, the pooling layers
``sequence_pool``, ``sequence_first_step``, ``sequence_last_step``, and
``sequence_softmax``, ``sequence_expand`` (counterpart of
``paddle_tpu/layers/sequence.py``; the other sequence layers come with
later slices).  A padded sequence var's lengths are its
``<name>@LEN`` companion (``layers.data(lod_level=1)``)."""

from ..layer_helper import LayerHelper

__all__ = ["padding_mask", "sequence_length", "dynamic_lstm",
           "dynamic_lstmp", "dynamic_gru", "sequence_pool",
           "sequence_first_step", "sequence_last_step", "sequence_softmax",
           "sequence_expand"]


def sequence_length(x, block=None):
    """The companion length Variable of a padded sequence var."""
    name = getattr(x, "_seq_len_name", None)
    if name is None:
        raise ValueError(
            "variable %r has no sequence-length companion; create it with "
            "layers.data(lod_level=1) or pass length= explicitly" % x.name)
    blk = block if block is not None else x.block
    return blk._find_var_recursive(name)


def _len_of(helper, x, length):
    if length is not None:
        return length
    return sequence_length(x)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 length=None):
    """LSTM over a padded sequence batch; ``input`` is [B, T, 4*size]
    (pre-projected by an fc), gates in the order (c, i, f, o)."""
    helper = LayerHelper("dynamic_lstm", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = size // 4 * 4
    h = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[h, 4 * h], dtype=dtype)
    bias_size = [1, 7 * h if use_peepholes else 4 * h]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias],
              "Length": [_len_of(helper, input, length)]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, length=None):
    helper = LayerHelper("dynamic_lstmp", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    h = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[proj_size, 4 * h], dtype=dtype)
    proj_weight = helper.create_parameter(
        attr=helper.param_attr, shape=[h, proj_size], dtype=dtype)
    bias_size = [1, 7 * h if use_peepholes else 4 * h]
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="lstmp",
        inputs={"Input": [input], "Weight": [weight],
                "ProjWeight": [proj_weight], "Bias": [bias],
                "Length": [_len_of(helper, input, length)]},
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, name=None,
                length=None):
    """GRU over a padded batch; ``input`` is [B, T, 3*size]."""
    helper = LayerHelper("dynamic_gru", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dtype = helper.input_dtype()
    weight = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    # the bias is added to the pre-projected input by an elementwise_add
    # ahead of the op
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=[3 * size], dtype=dtype, is_bias=True)
    biased = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="elementwise_add", inputs={"X": [input], "Y": [bias]},
        outputs={"Out": [biased]}, attrs={"axis": 2})
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [biased], "Weight": [weight],
              "Length": [_len_of(helper, input, length)]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru", inputs=inputs, outputs={"Hidden": [hidden]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def sequence_pool(input, pool_type, length=None):
    """Pool each row of a padded sequence over its length: ``pool_type``
    one of average, sum, sqrt, max, last, first."""
    helper = LayerHelper("sequence_pool", input=input)
    dtype = helper.input_dtype()
    out = helper.create_variable_for_type_inference(dtype)
    max_index = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input], "Length": [_len_of(helper, input, length)]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()})
    out._seq_len_name = None  # the time axis is pooled away
    return out


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_softmax(input, use_cudnn=False, name=None, length=None):
    helper = LayerHelper("sequence_softmax", input=input, name=name)
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="sequence_softmax",
        inputs={"X": [input], "Length": [_len_of(helper, input, length)]},
        outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None, length=None):
    helper = LayerHelper("sequence_expand", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ln = length if length is not None else sequence_length(y)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x], "Y": [y], "Length": [ln]},
        outputs={"Out": [out]})
    out._seq_len_name = ln.name
    return out


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
