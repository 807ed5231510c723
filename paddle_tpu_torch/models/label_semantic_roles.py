"""The book's semantic role labeller (the PaddlePaddle book, chapter 07,
label_semantic_roles; the JAX package's tests/book/
test_label_semantic_roles.py builds the same program op for op): word
embeddings, a DynamicRNN whose step is fc([word, previous], hidden,
tanh), a per-token emission fc over the tags, linear_chain_crf's
negative log-likelihood, mean, and Adam; the decode program shares the
parameters by name and ends in crf_decoding. The defaults are the
CoNLL-05 widths: vocab 44068 and 59 tags (paddle.dataset.conll05),
embedding width 32 (its get_embedding), hidden width 512 (chapter 07's
hidden_dim).

`conll05_batch` makes a feed by the JAX package's synthetic CoNLL-05
rule (paddle_tpu/dataset/conll05.py): sentence lengths uniform in
[5, 29], one predicate id a sentence, label = (word + predicate) % tags.
No dataset is downloaded.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..core.scope import create_lod_tensor
from ..framework import Program, program_guard
from ..optimizer import AdamOptimizer
from ..param_attr import ParamAttr

WIDTHS = {"vocab": 44068, "n_tag": 59, "emb_dim": 32, "hidden_dim": 512}
PRED_DICT_LEN = 3162


def emission_net(word, vocab=44068, n_tag=59, emb_dim=32, hidden_dim=512):
    """The per-token tag scores of the LoD ids `word`: [tokens, n_tag]."""
    emb = layers.embedding(word, [vocab, emb_dim],
                           param_attr=ParamAttr(name="w_emb"))
    drnn = layers.DynamicRNN()
    with drnn.block():
        w = drnn.step_input(emb)
        prev = drnn.memory(shape=[hidden_dim], value=0.0)
        h = layers.fc([w, prev], hidden_dim, act="tanh",
                      param_attr=[ParamAttr(name="r_wx"),
                                  ParamAttr(name="r_wh")],
                      bias_attr=ParamAttr(name="r_b"))
        drnn.update_memory(prev, h)
        drnn.output(h)
    return layers.fc(drnn(), n_tag, param_attr=ParamAttr(name="em_w"),
                     bias_attr=ParamAttr(name="em_b"))


def srl_train(lr=0.01, **widths):
    """(main, startup, avg_cost, emission) of the training program: feeds
    `word` and `tag` (int64, lod_level 1), the CRF's transition
    parameter `crfw`, AdamOptimizer(lr)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        word = layers.data("word", [1], dtype="int64", lod_level=1)
        tag = layers.data("tag", [1], dtype="int64", lod_level=1)
        emission = emission_net(word, **widths)
        crf_cost = layers.linear_chain_crf(
            emission, tag, param_attr=ParamAttr(name="crfw"))
        loss = layers.mean(crf_cost)
        AdamOptimizer(lr).minimize(loss)
    return main, startup, loss, emission


def srl_decode(**widths):
    """(program, path) of the decode program: feed `word`; `path` is the
    Viterbi tags, [tokens, 1] int32 with the feed's LoD. Its parameters
    are the training program's, by name (run it in the trained scope)."""
    prog = Program()
    with program_guard(prog, Program()):
        word = layers.data("word", [1], dtype="int64", lod_level=1)
        path = layers.crf_decoding(emission_net(word, **widths),
                                   ParamAttr(name="crfw"))
    return prog, path


def conll05_batch(rng, batch, vocab=44068, n_tag=59, place=None):
    """A feed of `batch` sentences by the synthetic CoNLL-05 rule: `word`
    and `tag` LoDTensors on `place` (None: CUDAPlace(0), as
    create_lod_tensor takes it); `rng` a numpy Generator."""
    lens = rng.integers(5, 30, batch)
    words = rng.integers(0, vocab, (int(lens.sum()), 1))
    pred = np.repeat(rng.integers(0, PRED_DICT_LEN, batch), lens)[:, None]
    tags = (words + pred) % n_tag
    return {"word": create_lod_tensor(words, [lens.tolist()], place),
            "tag": create_lod_tensor(tags, [lens.tolist()], place)}
