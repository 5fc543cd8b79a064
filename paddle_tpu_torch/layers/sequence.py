"""The sequence layers (counterpart of ``paddle_tpu/layers/sequence.py``),
the CRF and CTC layers (``linear_chain_crf``, ``crf_decoding``,
``chunk_eval``, ``warpctc``, ``ctc_greedy_decoder``, ``edit_distance``)
among them.  A padded sequence var's lengths are its ``<name>@LEN``
companion (``layers.data(lod_level=1)``); lengths propagate through ops
(``Block._infer_and_mark``), and every wrapper also takes an explicit
``length=`` Variable."""

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = ["padding_mask", "sequence_length", "dynamic_lstm",
           "dynamic_lstmp", "dynamic_gru", "sequence_pool",
           "sequence_first_step", "sequence_last_step", "sequence_softmax",
           "sequence_expand", "sequence_conv", "sequence_reverse",
           "sequence_mask", "sequence_concat", "sequence_erase",
           "sequence_enumerate", "row_conv", "causal_mask",
           "padding_attn_bias", "sequence_pad", "sequence_unpad",
           "sequence_reshape", "sequence_expand_as", "sequence_scatter",
           "im2sequence", "lod_reset", "linear_chain_crf", "crf_decoding",
           "chunk_eval", "warpctc", "ctc_greedy_decoder", "edit_distance"]


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


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None, length=None):
    helper = LayerHelper("sequence_conv", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    d = input.shape[-1]
    filter_shape = [filter_size * d, num_filters]
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [w],
                "Length": [_len_of(helper, input, length)]},
        outputs={"Out": [out]},
        attrs={"contextLength": filter_size,
               "contextStart": -((filter_size - 1) // 2),
               "contextStride": filter_stride})
    if helper.bias_attr is not None and \
            helper.kwargs.get("bias_attr") is not False:
        out = helper.append_bias_op(out, dim_start=2)
    # (the length companion propagates through bias/activation ops via
    # Block._infer_and_mark)
    return helper.append_activation(out)


def sequence_reverse(x, name=None, length=None):
    helper = LayerHelper("sequence_reverse", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_reverse",
        inputs={"X": [x], "Length": [_len_of(helper, x, length)]},
        outputs={"Out": [out]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """x: [batch] lengths -> [batch, maxlen] 0/1 mask."""
    if maxlen is None or (isinstance(maxlen, Variable)):
        raise ValueError("sequence_mask requires a static int maxlen")
    helper = LayerHelper("sequence_mask", input=x, name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="sequence_mask", inputs={"X": [x]}, outputs={"Y": [out]},
        attrs={"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def sequence_concat(input, name=None, lengths=None):
    helper = LayerHelper("sequence_concat", input=input, name=name)
    xs = list(input)
    lens = lengths or [sequence_length(v) for v in xs]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_concat",
        inputs={"X": xs, "Length": lens},
        outputs={"Out": [out], "OutLength": [out_len]})
    out._seq_len_name = out_len.name
    return out


def sequence_erase(input, tokens, name=None, length=None):
    helper = LayerHelper("sequence_erase", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_erase",
        inputs={"X": [input], "Length": [_len_of(helper, input, length)]},
        outputs={"Out": [out], "OutLength": [out_len]},
        attrs={"tokens": list(tokens)})
    out._seq_len_name = out_len.name
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None, length=None):
    helper = LayerHelper("sequence_enumerate", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_enumerate",
        inputs={"X": [input], "Length": [_len_of(helper, input, length)]},
        outputs={"Out": [out]},
        attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def row_conv(input, future_context_size, param_attr=None, act=None,
             name=None, length=None):
    helper = LayerHelper("row_conv", input=input, param_attr=param_attr,
                         act=act, name=name)
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape,
                                dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="row_conv",
        inputs={"X": [input], "Filter": [w],
                "Length": [_len_of(helper, input, length)]},
        outputs={"Out": [out]})
    return helper.append_activation(out)


def causal_mask(ref=None, seq_len=-1, mask_value=-1e9, dtype="float32",
                name=None):
    """[T, T] additive causal bias (0 on/below diagonal, mask_value above)
    for decoder self-attention; T from ``ref``'s time axis (runtime pad
    length) or a static ``seq_len``."""
    helper = LayerHelper("causal_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"Ref": [ref]} if ref is not None else {}
    helper.append_op(
        type="causal_mask", inputs=inputs, outputs={"Out": [out]},
        attrs={"seq_len": int(seq_len), "mask_value": float(mask_value),
               "dtype": dtype})
    out.stop_gradient = True
    out._seq_len_name = None
    return out


def padding_attn_bias(length, ref, mask_value=-1e9, dtype="float32",
                      name=None):
    """[B] lengths -> [B, 1, 1, T] additive attention bias, T from ``ref``."""
    helper = LayerHelper("padding_attn_bias", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="padding_attn_bias", inputs={"Length": [length], "Ref": [ref]},
        outputs={"Out": [out]},
        attrs={"mask_value": float(mask_value), "dtype": dtype})
    out.stop_gradient = True
    out._seq_len_name = None
    return out


def sequence_pad(x, pad_value=None, maxlen=None, name=None, length=None):
    """Pad a sequence batch to dense [B, T, ...].  Returns (out,
    lengths[int64])."""
    helper = LayerHelper("sequence_pad", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    seq_len = helper.create_variable_for_type_inference("int64")
    inputs = {"X": [x], "Length": [_len_of(helper, x, length)]}
    if pad_value is not None:
        inputs["PadValue"] = [pad_value]
    helper.append_op(
        type="sequence_pad", inputs=inputs,
        outputs={"Out": [out], "SeqLength": [seq_len]},
        attrs={"padded_length": int(maxlen) if maxlen else -1})
    out._seq_len_name = None          # dense output
    seq_len.stop_gradient = True
    return out, seq_len


def sequence_unpad(x, length, name=None):
    """Dense [B, T, ...] + lengths -> sequence batch."""
    helper = LayerHelper("sequence_unpad", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_unpad", inputs={"X": [x], "Length": [length]},
        outputs={"Out": [out], "OutLength": [out_len]})
    out._seq_len_name = out_len.name
    return out


def sequence_reshape(input, new_dim, length=None):
    """Re-chunk each sequence to rows of ``new_dim``."""
    helper = LayerHelper("sequence_reshape", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_reshape",
        inputs={"X": [input], "Length": [_len_of(helper, input, length)]},
        outputs={"Out": [out], "OutLength": [out_len]},
        attrs={"new_dim": int(new_dim)})
    out._seq_len_name = out_len.name
    return out


def sequence_expand_as(x, y, name=None, y_length=None):
    """Repeat row i of ``x`` to y's sequence-i length."""
    helper = LayerHelper("sequence_expand_as", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="sequence_expand_as",
        inputs={"X": [x], "Y": [y],
                "YLength": [_len_of(helper, y, y_length)]},
        outputs={"Out": [out], "OutLength": [out_len]})
    out._seq_len_name = out_len.name
    return out


def sequence_scatter(input, index, updates, name=None, length=None):
    """Scatter-add update sequences into dense rows."""
    helper = LayerHelper("sequence_scatter", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates],
                "Length": [_len_of(helper, index, length)]},
        outputs={"Out": [out]})
    out._seq_len_name = None
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """Image [B, C, H, W] -> patch sequence [B, oh * ow, C * kh * kw]."""
    helper = LayerHelper("im2sequence", input=input, name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding] * 4
    elif len(padding) == 2:
        padding = list(padding) * 2
    out = helper.create_variable_for_type_inference(input.dtype)
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="im2sequence", inputs={"X": [input]},
        outputs={"Out": [out], "OutLength": [out_len]},
        attrs={"kernels": list(filter_size), "strides": list(stride),
               "paddings": list(padding)})
    out._seq_len_name = out_len.name
    return out


def lod_reset(x, y=None, target_lod=None):
    """Replace the sequence-length companion of ``x``.  ``y``'s data is
    read as level-0 offsets; otherwise ``target_lod`` (offsets) is
    required."""
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64")
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = [int(v) for v in target_lod]
    else:
        raise ValueError("lod_reset needs y or target_lod")
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out], "Length": [length]},
                     attrs=attrs)
    out._seq_len_name = length.name
    return out


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Linear-chain CRF cost: ``input`` [B, T, D] emissions, ``label``
    [B, T, 1] int64 tags.  Creates the [D+2, D] transition (rows: start,
    end, D tag -> tag rows) and returns each sequence's negative
    log-likelihood [B, 1]."""
    helper = LayerHelper("linear_chain_crf", input=input,
                         param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size],
        dtype=helper.input_dtype())
    log_likelihood = helper.create_variable_for_type_inference(
        helper.input_dtype())
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input],
                "Length": [_len_of(helper, input, length)],
                "Transition": [transition], "Label": [label]},
        outputs={"LogLikelihood": [log_likelihood]})
    log_likelihood._seq_len_name = None
    return log_likelihood


def crf_decoding(input, param_attr=None, label=None, length=None):
    """Viterbi paths under the transition ``linear_chain_crf`` created
    with the same ``param_attr``; with ``label``, the per-position
    correctness mask."""
    helper = LayerHelper("crf_decoding", input=input, param_attr=param_attr)
    transition = helper.main_program.global_block()._find_var_recursive(
        helper.param_attr.name)
    if transition is None:
        raise ValueError(
            "crf_decoding: transition parameter %r not found; pass the "
            "same param_attr used by linear_chain_crf"
            % helper.param_attr.name)
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input],
              "Length": [_len_of(helper, input, length)],
              "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [path]})
    path.stop_gradient = True
    path._seq_len_name = getattr(input, "_seq_len_name", None)
    return path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, length=None):
    """Chunk precision, recall and F1.  Returns (precision, recall, f1,
    num_infer, num_label, num_correct)."""
    helper = LayerHelper("chunk_eval", input=input)
    outs = [helper.create_variable_for_type_inference(d)
            for d in ("float32",) * 3 + ("int64",) * 3]
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label],
                "Length": [_len_of(helper, input, length)]},
        outputs=dict(zip(("Precision", "Recall", "F1-Score",
                          "NumInferChunks", "NumLabelChunks",
                          "NumCorrectChunks"), ([v] for v in outs))),
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": int(num_chunk_types),
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    for v in outs:
        v.stop_gradient = True
        v._seq_len_name = None
    return tuple(outs)


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """CTC loss of ``input`` [B, T, num_classes + 1] unscaled logits
    against ``label`` [B, U, 1]; [B, 1]."""
    helper = LayerHelper("warpctc", input=input)
    loss = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(
        type="warpctc",
        inputs={"Logits": [input],
                "LogitsLength": [_len_of(helper, input, input_length)],
                "Label": [label],
                "LabelLength": [_len_of(helper, label, label_length)]},
        outputs={"Loss": [loss]},
        attrs={"blank": int(blank), "norm_by_times": bool(norm_by_times)})
    loss._seq_len_name = None
    return loss


def ctc_greedy_decoder(input, blank, input_length=None, name=None):
    """Greedy CTC decoding: the argmax a step, repeated tokens merged and
    blanks dropped."""
    from .tensor import argmax

    helper = LayerHelper("ctc_greedy_decoder", input=input, name=name)
    best = argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="ctc_align",
        inputs={"Input": [best],
                "Length": [_len_of(helper, input, input_length)]},
        outputs={"Output": [out], "OutputLength": [out_len]},
        attrs={"blank": int(blank), "merge_repeated": True})
    out.stop_gradient = True
    out._seq_len_name = out_len.name
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance of each (input, label) sequence pair, the
    ``ignored_tokens`` erased first.  Returns (distance [B, 1] float32,
    sequence_num [1] int64)."""
    helper = LayerHelper("edit_distance", input=input)
    if ignored_tokens:
        input = sequence_erase(input, tokens=list(ignored_tokens),
                               length=input_length)
        label = sequence_erase(label, tokens=list(ignored_tokens),
                               length=label_length)
        input_length = label_length = None
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="edit_distance",
        inputs={"Hyps": [input],
                "HypsLength": [_len_of(helper, input, input_length)],
                "Refs": [label],
                "RefsLength": [_len_of(helper, label, label_length)]},
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": bool(normalized)})
    for v in (out, seq_num):
        v.stop_gradient = True
        v._seq_len_name = None
    return out, seq_num
