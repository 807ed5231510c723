"""The PaddlePaddle book's sentiment classifiers (chapter 06,
understand_sentiment; the reference keeps them as
python/paddle/fluid/tests/book/notest_understand_sentiment.py):
convolution_net and stacked_lstm_net over variable-length reviews fed
as one LoD batch of word ids, trained with Adagrad on a sparse
embedding. Defaults are the book's widths (emb 128, hid 512, 3 stacked
LSTMs of hidden 128, 2 classes)."""
from __future__ import annotations

from .. import layers, nets
from ..framework import Program, program_guard
from ..optimizer import AdagradOptimizer


def convolution_net(data, label, input_dim, class_dim=2, emb_dim=128,
                    hid_dim=512, is_sparse=True):
    """Embedding, two sequence_conv_pool branches (windows of 3 and 4
    words, tanh, sqrt pooling) and an fc-softmax over both. Returns
    (avg_cost, accuracy, prediction)."""
    emb = layers.embedding(input=data, size=[input_dim, emb_dim],
                           is_sparse=is_sparse)
    conv_3 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=3, act="tanh",
                                     pool_type="sqrt")
    conv_4 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                     filter_size=4, act="tanh",
                                     pool_type="sqrt")
    prediction = layers.fc(input=[conv_3, conv_4], size=class_dim,
                           act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    accuracy = layers.accuracy(input=prediction, label=label)
    return avg_cost, accuracy, prediction


def stacked_lstm_net(data, label, input_dim, class_dim=2, emb_dim=128,
                     hid_dim=512, stacked_num=3, is_sparse=True):
    """Embedding, fc, then `stacked_num` dynamic_lstm layers (hidden
    hid_dim / 4; the even ones run each review backwards), each fed by
    an fc over the previous fc and LSTM; max sequence_pool of the last
    fc and LSTM, fc-softmax. Returns (avg_cost, accuracy, prediction)."""
    assert stacked_num % 2 == 1
    emb = layers.embedding(input=data, size=[input_dim, emb_dim],
                           is_sparse=is_sparse)
    fc1 = layers.fc(input=emb, size=hid_dim)
    lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim)
        lstm, _ = layers.dynamic_lstm(input=fc, size=hid_dim,
                                      is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    accuracy = layers.accuracy(input=prediction, label=label)
    return avg_cost, accuracy, prediction


NETS = {"conv": convolution_net, "stacked_lstm": stacked_lstm_net}


def sentiment_train(net="stacked_lstm", input_dim=5148, lr=0.002,
                    **widths):
    """(main, startup, avg_cost, accuracy, prediction) of the book's
    training program: `words` (int64 ids, lod_level 1) and `label`
    (int64 [B, 1]) feeds, the net, Adagrad(lr).minimize. `widths` go to
    the net (class_dim, emb_dim, hid_dim, stacked_num, is_sparse)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, acc, prediction = NETS[net](words, label, input_dim,
                                          **widths)
        AdagradOptimizer(learning_rate=lr).minimize(cost)
    return main, startup, cost, acc, prediction
