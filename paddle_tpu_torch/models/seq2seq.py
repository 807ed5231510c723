"""The book's RNN encoder-decoder (the PaddlePaddle book, chapter 08,
machine_translation; the JAX package's tests/book/
test_rnn_encoder_decoder.py builds the same program): a DynamicRNN
encoder over the ragged source, its last step booting a DynamicRNN
decoder teacher-forced over the target, a softmax fc over the target
vocabulary, cross_entropy, and Adam. The embeddings are dense, as in the
JAX model. The defaults are chapter 08's widths: dict 30000, word 512,
hidden 512.

`wmt14_batch` makes a feed of random ids with WMT14-shaped lengths
(log-normal, median 26, sigma 0.55, clipped to [2, 80], the bound of the
paddle.dataset.wmt14 reader), source and target lengths drawn apart: no
dataset is downloaded.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..core.scope import create_lod_tensor
from ..framework import Program, program_guard
from ..optimizer import AdamOptimizer
from ..param_attr import ParamAttr

BOS = 1


def encoder_decoder(src_vocab=30000, tgt_vocab=30000, word_dim=512,
                    hidden_dim=512):
    """Build the model in the current program: feeds `src`, `tgt_in`
    and `tgt_lab` (int64 ids, lod_level 1). Returns (avg_cost, logits);
    logits are the softmax over the target vocabulary, one row a target
    token."""
    src = layers.data("src", [1], dtype="int64", lod_level=1)
    tgt_in = layers.data("tgt_in", [1], dtype="int64", lod_level=1)
    tgt_lab = layers.data("tgt_lab", [1], dtype="int64", lod_level=1)

    src_emb = layers.embedding(src, [src_vocab, word_dim],
                               param_attr=ParamAttr(name="src_e"))
    enc = layers.DynamicRNN()
    with enc.block():
        w = enc.step_input(src_emb)
        prev = enc.memory(shape=[hidden_dim], value=0.0)
        h = layers.fc([w, prev], hidden_dim, act="tanh")
        enc.update_memory(prev, h)
        enc.output(h)
    enc_last = layers.sequence_last_step(enc())

    tgt_emb = layers.embedding(tgt_in, [tgt_vocab, word_dim],
                               param_attr=ParamAttr(name="tgt_e"))
    dec = layers.DynamicRNN()
    with dec.block():
        w = dec.step_input(tgt_emb)
        prev = dec.memory(init=enc_last, need_reorder=True)
        h = layers.fc([w, prev], hidden_dim, act="tanh")
        dec.update_memory(prev, h)
        dec.output(h)
    logits = layers.fc(dec(), tgt_vocab, act="softmax",
                       param_attr=ParamAttr(name="out_w"),
                       bias_attr=ParamAttr(name="out_b"))
    loss = layers.mean(layers.cross_entropy(logits, tgt_lab))
    return loss, logits


def seq2seq_train(lr=0.01, **widths):
    """(main, startup, avg_cost, logits) of the training program:
    encoder_decoder(**widths), then AdamOptimizer(lr).minimize."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        loss, logits = encoder_decoder(**widths)
        AdamOptimizer(lr).minimize(loss)
    return main, startup, loss, logits


def wmt14_lengths(rng, n, median=26.0, sigma=0.55, lo=2, hi=80):
    """`n` sentence lengths, log-normal around `median`, in [lo, hi]."""
    return np.clip(np.rint(rng.lognormal(np.log(median), sigma, n)),
                   lo, hi).astype(np.int64)


def wmt14_batch(rng, batch, src_vocab, tgt_vocab, place=None, **lengths):
    """A feed of `batch` sentence pairs of random ids (0 and BOS kept
    out of the words): `src`, `tgt_in` (BOS, then the target but its
    last word) and `tgt_lab` (the target), as LoDTensors on `place`
    (None: CUDAPlace(0), as create_lod_tensor takes it). `lengths` go
    to wmt14_lengths."""
    src_len = wmt14_lengths(rng, batch, **lengths)
    tgt_len = wmt14_lengths(rng, batch, **lengths)
    src = rng.integers(2, src_vocab, (int(src_len.sum()), 1))
    tgt = rng.integers(2, tgt_vocab, (int(tgt_len.sum()), 1))
    starts = np.concatenate([[0], np.cumsum(tgt_len)[:-1]])
    tgt_in = np.roll(tgt, 1, axis=0)
    tgt_in[starts] = BOS
    return {"src": create_lod_tensor(src, [src_len.tolist()], place),
            "tgt_in": create_lod_tensor(tgt_in, [tgt_len.tolist()], place),
            "tgt_lab": create_lod_tensor(tgt, [tgt_len.tolist()], place)}
