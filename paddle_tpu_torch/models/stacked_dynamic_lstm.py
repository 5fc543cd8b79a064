"""Stacked dynamic LSTM text classifier (counterpart of
``paddle_tpu/models/stacked_dynamic_lstm.py``): an embedding, then
``stacked_num`` LSTM layers, every other one reversed, each fed the
previous layer's fc input and output; max-pooled over time into a
softmax classifier."""

from .. import layers

__all__ = ["stacked_lstm_net"]


def stacked_lstm_net(word, dict_dim, class_dim=2, emb_dim=512, hid_dim=512,
                     stacked_num=3):
    emb = layers.embedding(word, size=[dict_dim, emb_dim])
    fc1 = layers.fc(emb, size=hid_dim * 4, num_flatten_dims=2)
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(inputs[0], size=hid_dim * 4, num_flatten_dims=2)
        fc = layers.elementwise_add(fc, layers.fc(
            inputs[1], size=hid_dim * 4, num_flatten_dims=2))
        lstm, cell = layers.dynamic_lstm(
            input=fc, size=hid_dim * 4, is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(inputs[1], pool_type="max")
    return layers.fc([fc_last, lstm_last], size=class_dim, act="softmax")
