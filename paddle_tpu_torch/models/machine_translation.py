"""RNN seq2seq translation with Bahdanau attention (counterpart of
``paddle_tpu/models/machine_translation.py``): a bidirectional LSTM
encoder over the source, and a ``DynamicRNN`` decoder whose step attends
over the encoder's output (``nets.simple_attention``, padded source
positions masked), runs an LSTM cell written out gate by gate
(``lstm_step``) and projects to the target vocabulary.  Sequences are
padded [B, T, 1] ids with ``@LEN`` companions; the encoder-side attention
projection is computed once, outside the decoder loop."""

from .. import layers
from .. import nets

__all__ = ["seq_to_seq_net", "lstm_step"]


def lstm_step(x_t, hidden_t_prev, cell_t_prev, size):
    """One LSTM step written out gate by gate: (hidden, cell)."""
    def linear(inputs):
        return layers.fc(input=inputs, size=size, bias_attr=True)

    forget_gate = layers.sigmoid(linear([hidden_t_prev, x_t]))
    input_gate = layers.sigmoid(linear([hidden_t_prev, x_t]))
    output_gate = layers.sigmoid(linear([hidden_t_prev, x_t]))
    cell_tilde = layers.tanh(linear([hidden_t_prev, x_t]))

    cell_t = layers.sums([
        layers.elementwise_mul(forget_gate, cell_t_prev),
        layers.elementwise_mul(input_gate, cell_tilde),
    ])
    hidden_t = layers.elementwise_mul(output_gate, layers.tanh(cell_t))
    return hidden_t, cell_t


def _bi_lstm_encoder(src_emb, size):
    """Forward and reverse dynamic_lstm over the pre-projected input;
    their hidden states concatenated."""
    fwd_in = layers.fc(src_emb, size=size * 4, num_flatten_dims=2,
                       bias_attr=False)
    fwd, _ = layers.dynamic_lstm(fwd_in, size=size * 4)
    rev_in = layers.fc(src_emb, size=size * 4, num_flatten_dims=2,
                       bias_attr=False)
    rev, _ = layers.dynamic_lstm(rev_in, size=size * 4, is_reverse=True)
    return layers.concat([fwd, rev], axis=2), rev   # [B, T, 2H], [B, T, H]


def seq_to_seq_net(src, tgt, label, source_dict_dim, target_dict_dim,
                   embedding_dim=512, encoder_size=512, decoder_size=512):
    """Training graph: returns (avg_cost, per-position predictions).

    ``src``/``tgt``/``label`` are int64 ``lod_level=1`` data vars
    ([B, T, 1] padded + @LEN).  ``label`` is ``tgt`` shifted left.
    """
    src_emb = layers.embedding(src, size=[source_dict_dim, embedding_dim])
    encoded_vector, rev = _bi_lstm_encoder(src_emb, encoder_size)

    # attention key projection, hoisted: one [B, T] gemm
    encoded_proj = layers.fc(encoded_vector, size=decoder_size,
                             num_flatten_dims=2, bias_attr=False)
    # the decoder starts from the backward encoder's first state
    backward_first = layers.sequence_first_step(rev)
    decoder_boot = layers.fc(backward_first, size=decoder_size,
                             act="tanh", bias_attr=False)

    src_len = layers.sequence_length(src)

    tgt_emb = layers.embedding(tgt, size=[target_dict_dim, embedding_dim])

    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(tgt_emb)
        enc_vec = rnn.static_input(encoded_vector)
        enc_proj = rnn.static_input(encoded_proj)
        hidden_mem = rnn.memory(init=decoder_boot)
        cell_mem = rnn.memory(shape=[decoder_size], value=0.0)

        # Bahdanau attention: masked softmax over tanh(enc_proj + W h)
        context = nets.simple_attention(enc_vec, enc_proj, hidden_mem,
                                        decoder_size, length=src_len)

        decoder_input = layers.concat([context, current_word], axis=1)
        h, c = lstm_step(decoder_input, hidden_mem, cell_mem,
                         decoder_size)
        rnn.update_memory(hidden_mem, h)
        rnn.update_memory(cell_mem, c)
        rnn.output(layers.fc(h, size=target_dict_dim, bias_attr=True))
    logits = rnn()                                          # [B, T, V]

    cost = layers.softmax_with_cross_entropy(logits, label)
    tgt_len = layers.sequence_length(tgt)
    mask = layers.padding_mask(tgt_len, logits)             # [B, T]
    masked = layers.elementwise_mul(cost,
                                    layers.unsqueeze(mask, axes=[2]))
    avg_cost = layers.elementwise_div(layers.reduce_sum(masked),
                                      layers.reduce_sum(mask))
    return avg_cost, logits
