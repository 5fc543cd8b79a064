"""Composite networks (counterpart of ``paddle_tpu/nets.py``):
``simple_img_conv_pool``, which the recognize_digits chapter needs,
``img_conv_group``, VGG's block, ``glu``, ``scaled_dot_product_attention``,
``sequence_conv_pool``, and the attention of the RNN seq2seq decoder,
``simple_attention`` and ``dot_product_attention``."""

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool",
           "simple_attention", "dot_product_attention"]


def simple_img_conv_pool(
    input, num_filters, filter_size, pool_size, pool_stride,
    pool_padding=0, pool_type="max", global_pooling=False,
    conv_stride=1, conv_padding=0, conv_dilation=1, conv_groups=1,
    param_attr=None, bias_attr=None, act=None, use_cudnn=True,
):
    """``conv2d`` (with ``act``) then ``pool2d``."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(
    input, conv_num_filter, pool_size, conv_padding=1, conv_filter_size=3,
    conv_act=None, param_attr=None, conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0.0, pool_stride=1, pool_type="max",
    use_cudnn=True,
):
    """``len(conv_num_filter)`` convolutions, each with its ``conv_act``
    or, where ``conv_with_batchnorm`` says, a batch norm carrying it and a
    dropout of ``conv_batchnorm_drop_rate`` (none at 0), then one
    ``pool2d``.  A per-conv argument is a list of that length or one
    value for all."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _expand(obj):
        if isinstance(obj, (list, tuple)):
            assert len(obj) == len(conv_num_filter)
            return list(obj)
        return [obj] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride,
    )


def glu(input, dim=-1):
    """Gated linear unit: split in half, a * sigmoid(b)."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    act_b = layers.sigmoid(b)
    return layers.elementwise_mul(x=a, y=act_b)


def scaled_dot_product_attention(
    queries, keys, values, num_heads=1, dropout_rate=0.0,
):
    """Multi-head scaled-dot-product attention over [batch, seq, dim]
    inputs, built from ``matmul``, ``scale`` and ``softmax`` ops (with a
    ``dropout`` of the weights at ``dropout_rate``)."""
    if not (len(queries.shape) == len(keys.shape) == len(values.shape) == 3):
        raise ValueError("inputs must be 3-D [batch, seq, dim]")
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if keys.shape[1] != values.shape[1]:
        raise ValueError("keys and values must share sequence length")
    if queries.shape[-1] % num_heads != 0:
        raise ValueError("hidden size must divide num_heads")

    def __split_heads(x, num_heads):
        if num_heads == 1:
            return x
        hidden_size = x.shape[-1]
        reshaped = layers.reshape(
            x, shape=[0, 0, num_heads, hidden_size // num_heads]
        )
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def __combine_heads(x):
        if len(x.shape) == 3:
            return x
        trans = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            trans, shape=[0, 0, trans.shape[2] * trans.shape[3]]
        )

    q = __split_heads(queries, num_heads)
    k = __split_heads(keys, num_heads)
    v = __split_heads(values, num_heads)

    key_dim_per_head = keys.shape[-1] // num_heads
    scaled_q = layers.scale(x=q, scale=key_dim_per_head ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)

    # softmax over the key axis directly
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate,
                                 is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return __combine_heads(ctx_multiheads)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None,
                       length=None):
    """sequence_conv followed by sequence_pool.  ``input`` is a padded
    sequence batch [B, T, D] with a @LEN companion; returns the pooled
    [B, num_filters] features."""
    conv = layers.sequence_conv(input, num_filters=num_filters,
                                filter_size=filter_size, act=act,
                                param_attr=param_attr,
                                bias_attr=bias_attr, length=length)
    return layers.sequence_pool(conv, pool_type, length=length)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     decoder_size, length=None):
    """Bahdanau additive attention over a padded sequence.

    ``encoded_sequence`` [B, T, H] values; ``encoded_proj`` [B, T, D]
    pre-projected keys (hoist the key projection out of the decode loop
    — one big gemm instead of one per step); ``decoder_state`` [B, D].
    ``length`` masks padded timesteps (defaults to encoded_sequence's
    @LEN companion).  Returns the context vector [B, H].

    score[b,t] = v . tanh(enc_proj[b,t] + W s[b]); masked softmax over
    t; context = sum_t w[b,t] * enc[b,t].
    """
    dec_proj = layers.fc(decoder_state, size=decoder_size, bias_attr=False)
    mixed = layers.tanh(
        layers.elementwise_add(encoded_proj,
                               layers.unsqueeze(dec_proj, axes=[1])))
    scores = layers.squeeze(
        layers.fc(mixed, size=1, num_flatten_dims=2, bias_attr=False),
        axes=[2])                                           # [B, T]
    weights = layers.sequence_softmax(scores, length=length)
    return layers.reduce_sum(
        layers.elementwise_mul(encoded_sequence,
                               layers.unsqueeze(weights, axes=[2])),
        dim=1)


def dot_product_attention(encoded_sequence, attended_sequence,
                          transformed_state, length=None):
    """Single-query dot-product attention.

    ``encoded_sequence`` [B, T, D] keys; ``attended_sequence`` [B, T, H]
    values; ``transformed_state`` [B, D] query (pre-projected).  Returns the context [B, H].
    """
    scores = layers.reduce_sum(
        layers.elementwise_mul(encoded_sequence,
                               layers.unsqueeze(transformed_state,
                                                axes=[1])),
        dim=2)                                              # [B, T]
    weights = layers.sequence_softmax(scores, length=length)
    return layers.reduce_sum(
        layers.elementwise_mul(attended_sequence,
                               layers.unsqueeze(weights, axes=[2])),
        dim=1)
