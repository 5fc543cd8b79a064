"""Transformer-base NMT (counterpart of ``paddle_tpu/models/transformer.py``).

Built from the layers over padded sequences: the attention projections
and the vocabulary projection are ``mul`` products (``torch.matmul``),
attention is the ``fused_attention`` op (the hand-written flash-attention
kernels), every sublayer ends in ``layer_norm`` (the layer-norm kernels),
and the loss is ``softmax_with_cross_entropy`` with fused label smoothing
(the softmax-xent kernels).  Masks come from the ``<name>@LEN`` length
companions.  The programs are the JAX builder's, op for op and attr for
attr; ``pipeline_microbatches`` stages each stack into a
``layers.Pipeline`` region (the ``pipeline_region`` op).

Architecture: post-norm Transformer (Vaswani et al.): d_model 512,
n_head 8, 6+6 layers, ffn 2048, separate source and target embeddings,
label smoothing and the noam schedule wired by the caller.
"""

import numpy as np

from .. import layers
from ..initializer import NumpyArrayInitializer
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["transformer", "wrap_encoder", "wrap_decoder",
           "position_encoding_init"]


def position_encoding_init(n_position, d_model):
    """Sinusoid position encoding table [n_position, d_model]."""
    pos = np.arange(n_position)[:, None].astype("float64")
    dim = np.arange(d_model // 2)[None, :].astype("float64")
    angle = pos / np.power(10000.0, 2 * dim / d_model)
    enc = np.zeros((n_position, d_model))
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc.astype("float32")


def _multi_head_attention(queries, keys, values, k_len, causal, d_model,
                          n_head, dropout_rate, is_test, cache_name):
    d_key = d_model // n_head
    q = layers.fc(queries, size=d_model, num_flatten_dims=2, bias_attr=False,
                  name=cache_name + "_q")
    k = layers.fc(keys, size=d_model, num_flatten_dims=2, bias_attr=False,
                  name=cache_name + "_k")
    v = layers.fc(values, size=d_model, num_flatten_dims=2, bias_attr=False,
                  name=cache_name + "_v")

    def split_heads(x):
        r = layers.reshape(x, shape=[0, 0, n_head, d_key])
        return layers.transpose(r, perm=[0, 2, 1, 3])

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    # fused flash attention: structural masks (k_len padding + causal)
    # instead of a materialized [B, H, Tq, Tk] additive bias; weight
    # dropout happens inside the kernel (ops/attention.py)
    ctx = layers.fused_attention(q, k, v, k_len=k_len, causal=causal,
                                 dropout_rate=dropout_rate, is_test=is_test,
                                 scale=d_key ** -0.5)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[0, 0, d_model])
    return layers.fc(ctx, size=d_model, num_flatten_dims=2, bias_attr=False,
                     name=cache_name + "_o")


def _ffn(x, d_inner, d_model, is_test, dropout_rate, name):
    h = layers.fc(x, size=d_inner, num_flatten_dims=2, act="relu",
                  name=name + "_fc1")
    if dropout_rate:
        h = layers.dropout(h, dropout_prob=dropout_rate, is_test=is_test)
    return layers.fc(h, size=d_model, num_flatten_dims=2, name=name + "_fc2")


def _post_process(prev, sublayer_out, dropout_rate, is_test):
    if dropout_rate:
        sublayer_out = layers.dropout(sublayer_out,
                                      dropout_prob=dropout_rate,
                                      is_test=is_test)
    added = layers.elementwise_add(prev, sublayer_out)
    return layers.layer_norm(added, begin_norm_axis=2)


def _prepare_embedding(word, pos_table_name, vocab_size, d_model, max_len,
                       dropout_rate, is_test, name):
    emb = layers.embedding(
        word, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=name + "_word_emb"))
    emb = layers.scale(emb, scale=d_model ** 0.5)
    pos_enc = position_encoding_init(max_len, d_model)
    pos_param = ParamAttr(
        name=pos_table_name,
        initializer=NumpyArrayInitializer(pos_enc),
        trainable=False)
    helper = LayerHelper(name + "_posenc")
    table = helper.create_parameter(
        attr=pos_param, shape=[max_len, d_model], dtype="float32")
    out = helper.create_variable_for_type_inference("float32")
    # table[:T] added at trace time (T is the runtime pad length)
    helper.append_op(
        type="add_position_encoding",
        inputs={"X": [emb], "Table": [table]},
        outputs={"Out": [out]})
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate, is_test=is_test)
    out._seq_len_name = word._seq_len_name
    return out


def _staged(x, n_layer, layer_fn, pipeline_microbatches,
            pipeline_layers_per_stage, sides):
    """``n_layer`` layers over ``x``, staged into a ``layers.Pipeline``
    region of ``pipeline_layers_per_stage`` consecutive layers a stage
    when ``pipeline_microbatches`` is set; ``sides`` gives the region's
    side inputs (the last one the layers read as their second input).
    ``layer_fn(h, side, i)`` builds layer i."""
    if not pipeline_microbatches:
        for i in range(n_layer):
            x = layer_fn(x, sides[-1] if sides else None, i)
        return x
    g = max(1, int(pipeline_layers_per_stage or 1))
    if n_layer % g:
        raise ValueError(
            "pipeline_layers_per_stage (%d) must divide n_layer "
            "(%d)" % (g, n_layer))
    pipe = layers.Pipeline(microbatches=pipeline_microbatches)
    for s0 in range(0, n_layer, g):
        with pipe.stage():
            h = pipe.carry(x if s0 == 0 else None)
            side = None
            for v in sides:
                side = pipe.side(v)
            for i in range(s0, s0 + g):
                h = layer_fn(h, side, i)
            pipe.emit(h)
    return pipe()


def wrap_encoder(src_word, src_max_len, vocab_size, n_layer=6, n_head=8,
                 d_model=512, d_inner=2048, dropout_rate=0.1, is_test=False,
                 pipeline_microbatches=None, pipeline_layers_per_stage=1):
    """The encoder stack over ``src_word``.  ``pipeline_microbatches``
    stages the layers into a ``layers.Pipeline`` region
    (``pipeline_layers_per_stage`` consecutive layers a stage), which runs
    as a pipeline schedule when the ``ParallelExecutor``'s mesh has a
    ``pp`` axis of the stage count (or dividing it, for the interleaved
    schedule); the losses are the same either way."""
    src_len = src_word.block._find_var_recursive(src_word._seq_len_name)
    enc_in = _prepare_embedding(src_word, "src_pos_enc", vocab_size, d_model,
                                src_max_len, dropout_rate, is_test, "src")

    def enc_layer(x, _, i):
        attn = _multi_head_attention(x, x, x, src_len, False, d_model,
                                     n_head, dropout_rate, is_test,
                                     "enc%d_attn" % i)
        x = _post_process(x, attn, dropout_rate, is_test)
        ffn = _ffn(x, d_inner, d_model, is_test, dropout_rate,
                   "enc%d_ffn" % i)
        return _post_process(x, ffn, dropout_rate, is_test)

    x = _staged(enc_in, n_layer, enc_layer, pipeline_microbatches,
                pipeline_layers_per_stage, [src_len])
    x._seq_len_name = src_word._seq_len_name
    return x


def wrap_decoder(tgt_word, enc_out, tgt_max_len, vocab_size, n_layer=6,
                 n_head=8, d_model=512, d_inner=2048, dropout_rate=0.1,
                 is_test=False, pipeline_microbatches=None,
                 pipeline_layers_per_stage=1):
    """The decoder stack and the vocabulary projection; returns the
    logits.  ``pipeline_microbatches`` stages the layers as in
    ``wrap_encoder``, the encoder's output a per-microbatch side input of
    the region."""
    tgt_len = tgt_word.block._find_var_recursive(tgt_word._seq_len_name)
    src_len = enc_out.block._find_var_recursive(enc_out._seq_len_name)
    dec_in = _prepare_embedding(tgt_word, "tgt_pos_enc", vocab_size, d_model,
                                tgt_max_len, dropout_rate, is_test, "tgt")

    def dec_layer(x, enc, i):
        self_attn = _multi_head_attention(x, x, x, tgt_len, True, d_model,
                                          n_head, dropout_rate, is_test,
                                          "dec%d_self" % i)
        x = _post_process(x, self_attn, dropout_rate, is_test)
        cross = _multi_head_attention(x, enc, enc, src_len, False,
                                      d_model, n_head, dropout_rate,
                                      is_test, "dec%d_cross" % i)
        x = _post_process(x, cross, dropout_rate, is_test)
        ffn = _ffn(x, d_inner, d_model, is_test, dropout_rate,
                   "dec%d_ffn" % i)
        return _post_process(x, ffn, dropout_rate, is_test)

    x = _staged(dec_in, n_layer, dec_layer, pipeline_microbatches,
                pipeline_layers_per_stage, [tgt_len, src_len, enc_out])
    logits = layers.fc(x, size=vocab_size, num_flatten_dims=2,
                       name="dec_logits")
    return logits


def transformer(src_word, tgt_word, label, src_max_len, tgt_max_len,
                src_vocab_size, tgt_vocab_size, n_layer=6, n_head=8,
                d_model=512, d_inner=2048, dropout_rate=0.1,
                label_smooth_eps=0.1, is_test=False,
                pipeline_microbatches=None, pipeline_layers_per_stage=1):
    """Full train graph: returns (avg_cost, logits).  The cost is the
    label-smoothed cross-entropy averaged over the target tokens inside
    each row's length.  ``pipeline_microbatches`` stages the encoder and
    decoder stacks into two pipeline regions (``pipeline_layers_per_stage``
    consecutive layers a stage) for ``pp`` meshes."""
    enc_out = wrap_encoder(src_word, src_max_len, src_vocab_size, n_layer,
                           n_head, d_model, d_inner, dropout_rate, is_test,
                           pipeline_microbatches,
                           pipeline_layers_per_stage)
    logits = wrap_decoder(tgt_word, enc_out, tgt_max_len, tgt_vocab_size,
                          n_layer, n_head, d_model, d_inner, dropout_rate,
                          is_test, pipeline_microbatches,
                          pipeline_layers_per_stage)
    # label: [B, T, 1] int64 ids (padded); mask from tgt lengths
    tgt_len = tgt_word.block._find_var_recursive(tgt_word._seq_len_name)
    # uniform smoothing fused into the loss kernel: the reference's
    # one_hot + label_smooth + soft-label CE materializes a [B, T, V]
    # soft-label tensor (0.5 GB at the benchmark shapes) three times
    cost = layers.softmax_with_cross_entropy(
        logits, label, label_smooth_eps=label_smooth_eps)
    mask = layers.padding_mask(tgt_len, logits)  # [B,T]
    mask3 = layers.unsqueeze(mask, axes=[2])
    masked = layers.elementwise_mul(cost, mask3)
    total = layers.reduce_sum(masked)
    n_tok = layers.reduce_sum(mask)
    avg_cost = layers.elementwise_div(total, n_tok)
    return avg_cost, logits
