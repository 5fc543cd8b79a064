"""Neural-network layers of the serving and training slices (counterpart
of ``paddle_tpu/layers/nn.py``): ``fc``, ``embedding``, ``dropout``,
``softmax``, ``cross_entropy``, ``softmax_with_cross_entropy``, ``mean``,
``matmul``, ``fused_attention``, ``square_error_cost``, ``topk``,
``prelu``, ``maxout``, ``cos_sim``, ``margin_rank_loss``,
``lstm_unit``, ``gru_unit``, the elementwise layers,
``autoincreased_step_counter``, and the plain op library's ``one_hot``,
``mul``, ``label_smooth``, ``sampling_id``, ``smooth_l1``, ``clip``,
``clip_by_norm``, ``flatten``, ``sum``, ``multiplex``, ``rank_loss``,
``sigmoid_cross_entropy_with_logits``, ``gaussian_random`` and
``dice_loss``, and the sampled losses and metric ``nce``, ``hsigmoid``,
``bilinear_tensor_product`` and ``mean_iou`` (``relu`` and ``log`` are
generated with the activations,
``layers/ops.py``).  They append the same ops with
the same attrs as the JAX package, so the programs serialize alike."""

from ..framework import Variable
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "dropout", "softmax", "cross_entropy",
           "softmax_with_cross_entropy", "mean", "matmul", "fused_attention",
           "paged_attention",
           "square_error_cost", "topk", "elementwise_add", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_pow", "prelu", "maxout",
           "cos_sim", "margin_rank_loss", "lstm_unit", "gru_unit",
           "autoincreased_step_counter", "l2_normalize",
           "image_resize_short", "one_hot", "mul", "label_smooth",
           "sampling_id", "smooth_l1", "clip", "clip_by_norm", "flatten",
           "sum", "multiplex", "rank_loss",
           "sigmoid_cross_entropy_with_logits", "gaussian_random",
           "dice_loss", "nce", "hsigmoid", "bilinear_tensor_product",
           "mean_iou"]


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
    """Embedding lookup (``lookup_table``).  ``is_sparse`` makes the
    table's gradient a SelectedRows of the looked-up rows
    (``ops/selected_rows.py``), which the optimizers update lazily.
    ``is_distributed`` is recorded for program parity; on one device the
    table trains unsharded, as the JAX package's does without a mesh (the
    sharded tables wait for ROADMAP A7)."""
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


def paged_attention(q, k_cache, v_cache, page_table, k_len=None,
                    k_scale=None, v_scale=None, causal=True, scale=None,
                    name=None):
    """Attention over a block-indexed KV pool (serving's paged cache):
    ``q`` [S, H, Tq, D] attends the pages ``page_table`` [S, max_pages]
    maps for each slot out of ``k_cache``/``v_cache`` [P, H, page_size,
    D]; ``k_len`` [S] is each slot's valid length.  int8 pools dequantize
    through ``k_scale``/``v_scale`` [P, H, page_size].  Causal ``Tq > 1``
    is the bottom-aligned suffix query the speculative verify uses."""
    helper = LayerHelper("paged_attention", name=name)
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    inputs = {"Q": [q], "KCache": [k_cache], "VCache": [v_cache],
              "PageTable": [page_table]}
    if k_len is not None:
        inputs["KLen"] = [k_len]
    if k_scale is not None:
        inputs["KScale"] = [k_scale]
        inputs["VScale"] = [v_scale]
    attrs = {"causal": causal}
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type="paged_attention", inputs=inputs,
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
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    """``x / sqrt(max(sum(x^2, axis), epsilon))``, built from ``square``,
    ``reduce_sum``, ``clip``, ``sqrt`` and ``elementwise_div`` as the JAX
    package builds it."""
    helper = LayerHelper("l2_normalize", name=name)

    def append(op_type, inputs, attrs=None):
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]},
                         attrs=attrs)
        return out

    sq = append("square", {"X": [x]})
    ssum = append("reduce_sum", {"X": [sq]},
                  {"dim": [axis], "keep_dim": True, "reduce_all": False})
    norm = append("clip", {"X": [ssum]}, {"min": epsilon, "max": 3.4e38})
    root = append("sqrt", {"X": [norm]})
    return append("elementwise_div", {"X": [x], "Y": [root]}, {"axis": 0})


def prelu(x, mode, param_attr=None, name=None):
    """Parametric ReLU with one learnable slope (``all``), one a channel
    (``channel``) or one an element (``element``), initialised to 0.25."""
    helper = LayerHelper("prelu", name=name, param_attr=param_attr)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    elif mode == "element":
        alpha_shape = [1]
        for s in x.shape[1:]:
            alpha_shape[0] *= s
    else:
        raise ValueError("mode must be all|channel|element")
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(dtype=X.dtype)
    xnorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    ynorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    helper.append_op(
        type="cos_sim", inputs={"X": [X], "Y": [Y]},
        outputs={"Out": [out], "XNorm": [xnorm], "YNorm": [ynorm]},
    )
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    """Pairwise hinge max(0, -label*(left-right) + margin); label is
    +-1."""
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=left.dtype)
    act = helper.create_variable_for_type_inference(dtype=left.dtype)
    helper.append_op(
        type="margin_rank_loss",
        inputs={"Label": [label], "X1": [left], "X2": [right]},
        outputs={"Out": [out], "Activated": [act]},
        attrs={"margin": float(margin)},
    )
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: fc([x_t, h_prev]) -> 4 gates -> lstm_unit op.
    Returns (hidden, cell)."""
    if len(x_t.shape) != 2 or len(hidden_t_prev.shape) != 2 or \
            len(cell_t_prev.shape) != 2:
        raise ValueError("lstm_unit takes 2-D x_t/hidden/cell")
    from .tensor import concat
    size = int(cell_t_prev.shape[1])
    concat_in = concat([x_t, hidden_t_prev], axis=1)
    fc_out = fc(concat_in, size=4 * size, param_attr=param_attr,
                bias_attr=bias_attr, name=name)
    helper = LayerHelper("lstm_unit", name=name)
    h = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    c = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
        outputs={"H": [h], "C": [c]},
        attrs={"forget_bias": float(forget_bias)})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid"):
    """One GRU step over a pre-projected input (``input`` is the
    fc-transformed x, ``size`` = 3x the hidden dim).  Returns (hidden,
    reset_hidden_prev, gate)."""
    h_dim = size // 3
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[h_dim, 3 * h_dim],
                                dtype=input.dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if helper.kwargs.get("bias_attr") is not False:
        b = helper.create_parameter(attr=helper.bias_attr,
                                    shape=[1, 3 * h_dim],
                                    dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    h = helper.create_variable_for_type_inference(dtype=input.dtype)
    gate = helper.create_variable_for_type_inference(dtype=input.dtype)
    rhp = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="gru_unit", inputs=inputs,
        outputs={"Hidden": [h], "Gate": [gate], "ResetHiddenPrev": [rhp]},
        attrs={"activation": activation,
               "gate_activation": gate_activation})
    return h, rhp, gate


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


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize NCHW ``input`` so its shorter side is ``out_short_len``,
    keeping the aspect ratio."""
    from .cnn import image_resize

    if len(input.shape) != 4:
        raise ValueError("image_resize_short expects NCHW input")
    hw = list(input.shape[2:4])
    short = hw.index(min(hw))
    out_shape = list(hw)
    out_shape[short] = int(out_short_len)
    out_shape[1 - short] = int(round(float(hw[1 - short]) / hw[short]
                                     * out_short_len))
    return image_resize(input, out_shape=out_shape, resample=resample)


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"min": min, "max": max, "seed": seed})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(dtype=x.dtype)
    loss = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def flatten(x, axis=1, name=None):
    """``x`` as a matrix: the dims before ``axis`` make the rows."""
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="flatten", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": int(axis)})
    return out


def sum(x):
    """The elementwise sum of a list of tensors."""
    if isinstance(x, Variable):
        x = [x]
    helper = LayerHelper("sum")
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(x)},
                     outputs={"Out": [out]})
    return out


def multiplex(inputs, index):
    """Row i of the result is row i of ``inputs[index[i]]``."""
    if not isinstance(inputs, (list, tuple)) or len(inputs) < 2:
        raise ValueError("multiplex needs at least 2 candidate tensors")
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(dtype=inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": list(inputs), "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def rank_loss(label, left, right, name=None):
    """RankNet's pairwise loss log(1 + e^(left - right)) - label (left -
    right)."""
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=left.dtype)
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={"Out": [out]})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    """Elementwise binary cross-entropy of logits ``x``."""
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """A normal random tensor drawn at every run; ``seed`` is kept for the
    API (the executor's generator draws)."""
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(type="gaussian_random", inputs={},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "mean": float(mean),
                            "std": float(std), "seed": int(seed),
                            "dtype": dtype})
    return out


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2 |input . one_hot(label)| / (|input| + |one_hot| + epsilon),
    averaged over the batch, composed of the ops the JAX layer uses."""
    from . import tensor as tensor_layers
    from .ops import scale

    label = one_hot(label, depth=input.shape[-1])
    dims = list(range(1, len(input.shape)))
    inse = tensor_layers.reduce_sum(elementwise_mul(input, label), dim=dims)
    denom = elementwise_add(tensor_layers.reduce_sum(input, dim=dims),
                            tensor_layers.reduce_sum(label, dim=dims))
    one = tensor_layers.fill_constant(shape=[1], dtype=input.dtype,
                                      value=1.0)
    score = elementwise_sub(one, elementwise_div(
        scale(inse, scale=2.0),
        elementwise_add(denom, tensor_layers.fill_constant(
            shape=[1], dtype=input.dtype, value=float(epsilon)))))
    return tensor_layers.reduce_mean(score)


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None, name=None):
    """Noise-contrastive estimation: each row's cost [B, 1] over its true
    classes and ``num_neg_samples`` uniform negatives."""
    helper = LayerHelper("nce", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    num_true = label.shape[-1] if len(label.shape) > 1 else 1
    num_neg = int(num_neg_samples) if num_neg_samples else 10
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if helper.kwargs.get("bias_attr") is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[num_total_classes, 1],
            dtype=input.dtype, is_bias=True)]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    cost = helper.create_variable_for_type_inference(input.dtype)
    logits = helper.create_variable_for_type_inference(input.dtype)
    labels_out = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [logits],
                 "SampleLabels": [labels_out]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": num_neg, "num_true": int(num_true)})
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid over a complete binary tree: each row's cost
    [B, 1]."""
    helper = LayerHelper("hsigmoid", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[num_classes - 1, input.shape[-1]],
                                dtype=input.dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if helper.kwargs.get("bias_attr") is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[num_classes - 1, 1],
            dtype=input.dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="hierarchical_sigmoid", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"num_classes": int(num_classes)})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """out_k = x . W_k . y (+ b_k)."""
    helper = LayerHelper("bilinear_tensor_product", input=x,
                         param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    w = helper.create_parameter(attr=helper.param_attr,
                                shape=[size, x.shape[-1], y.shape[-1]],
                                dtype=x.dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if helper.kwargs.get("bias_attr") is not False:
        inputs["Bias"] = [helper.create_parameter(
            attr=helper.bias_attr, shape=[1, size], dtype=x.dtype,
            is_bias=True)]
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def mean_iou(input, label, num_classes):
    """Mean intersection over union.  Returns (mean_iou, out_wrong,
    out_correct)."""
    helper = LayerHelper("mean_iou")
    iou = helper.create_variable_for_type_inference(dtype="float32")
    wrong = helper.create_variable_for_type_inference(dtype="int32")
    correct = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="mean_iou",
        inputs={"Predictions": [input], "Labels": [label]},
        outputs={"OutMeanIou": [iou], "OutWrong": [wrong],
                 "OutCorrect": [correct]},
        attrs={"num_classes": int(num_classes)})
    return iou, wrong, correct
