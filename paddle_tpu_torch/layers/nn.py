"""Neural-network layers of the serving and training slices (counterpart
of ``paddle_tpu/layers/nn.py``): ``fc``, ``embedding``, ``dropout``,
``softmax``, ``cross_entropy``, ``softmax_with_cross_entropy``, ``mean``,
``matmul``, ``fused_attention``, ``square_error_cost``, ``topk``, the
elementwise layers and ``autoincreased_step_counter``.  They append the same ops with
the same attrs as the JAX package, so the programs serialize alike."""

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "dropout", "softmax", "cross_entropy",
           "softmax_with_cross_entropy", "mean", "matmul", "fused_attention",
           "square_error_cost", "topk", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div",
           "autoincreased_step_counter"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: per-input ``mul`` (weights [in, out] for
    ``x @ W``), summed, plus bias and activation."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        w_rows = 1
        for s in input_var.shape[num_flatten_dims:]:
            w_rows *= s
        w = helper.create_parameter(attr=p_attr, shape=[w_rows, size],
                                    dtype=dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    if helper.bias_attr and helper.kwargs.get("bias_attr") is not False:
        pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (``lookup_table``).  ``is_sparse`` and
    ``is_distributed`` are recorded for program parity; the sparse
    gradient and sharded tables come with later slices."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(attr=helper.param_attr, shape=size,
                                dtype=dtype, is_bias=False)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = (
        -1 if padding_idx is None
        else padding_idx if padding_idx >= 0
        else (size[0] + padding_idx))
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx},
    )
    return tmp


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0,
               "dropout_implementation": dropout_implementation})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """-log of the probability ``input`` gives ``label`` (or -sum(label
    log input) with ``soft_label``), one value per row."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, label_smooth_eps=0.0):
    """Fused softmax + cross-entropy over the last axis, with uniform label
    smoothing ``label_smooth_eps`` fused into the loss."""
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(
        dtype=logits.dtype)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index,
               "label_smooth_eps": float(label_smooth_eps)})
    if return_softmax:
        return loss, softmax_out
    return loss


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def fused_attention(q, k, v, k_len=None, causal=False, dropout_rate=0.0,
                    is_test=False, scale=None, name=None):
    """Flash attention over head-split q/k/v [B, H, T, D]; ``k_len`` [B]
    masks padded keys, ``causal`` adds the autoregressive mask."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if k_len is not None:
        inputs["KLen"] = [k_len]
    attrs = {"causal": causal, "dropout_rate": float(dropout_rate),
             "is_test": is_test}
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="fused_attention", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def square_error_cost(input, label):
    """Per-sample squared error (input - label)^2."""
    helper = LayerHelper("square_error_cost", input=input)
    minus_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]}, attrs={"axis": -1})
    square_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [square_out]})
    return square_out


def topk(input, k, name=None):
    """The k largest values of the last axis and their indices (equal
    values lowest index first)."""
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def _elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")


def autoincreased_step_counter(counter_name=None, begin=1, step=1,
                               dtype="int64"):
    """A persistable counter advanced once per executed step; the LR
    schedules' step counter is one of these."""
    helper = LayerHelper("step_counter")
    block = helper.main_program.global_block()
    name = counter_name or "@STEP_COUNTER@"
    counter = block._find_var_recursive(name)
    if counter is None:
        counter = block.create_var(name=name, shape=(1,), dtype=dtype,
                                   persistable=True)
        startup_blk = helper.startup_program.global_block()
        startup_blk.create_var(name=name, shape=(1,), dtype=dtype,
                               persistable=True)
        ConstantInitializer(value=float(begin - step))(counter, startup_blk)
        helper.append_op(
            type="increment", inputs={"X": [counter]},
            outputs={"Out": [counter]}, attrs={"step": float(step)})
        counter.stop_gradient = True
    return counter
