"""Stacked dynamic LSTM sentiment model (port of
``paddle_tpu/models/stacked_dynamic_lstm.py``) — parity with
benchmark/fluid/models/stacked_dynamic_lstm.py (reference): embedding →
fc → stacked [fc + dynamic_lstm] → last-pool of max-pools → fc softmax.
"""
from .. import layers

__all__ = ["stacked_lstm_net"]


def stacked_lstm_net(data, label, dict_dim, emb_dim=128, hid_dim=512,
                     stacked_num=3, class_num=2):
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    # embedding over a lod var yields a sequence; first projection.
    # fluid convention: dynamic_lstm(size=X) has hidden X/4 and consumes
    # an [.., X] projected input (reference stacked_dynamic_lstm.py)
    fc1 = layers.fc(input=emb, size=hid_dim)
    fc1.lod_level = 1
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim)

    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        concat = layers.concat(inputs, axis=-1)
        fc = layers.fc(input=concat, size=hid_dim)
        fc.lod_level = 1
        lstm, cell = layers.dynamic_lstm(input=fc, size=hid_dim,
                                         is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_num,
                           act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
