"""The book's machine translation model with its beam-search decoder
(the PaddlePaddle book, chapter 08, machine_translation; the JAX
package's tests/book/test_machine_translation.py builds the same two
programs op for op).

Training: a DynamicRNN encoder over the ragged source, its last step
booting a DynamicRNN decoder teacher-forced over the target, a softmax
fc over the vocabulary, cross_entropy, Adam. Decoding: the encoder, then
`max_len` statically unrolled steps, each embedding, the decoder's step
fc, the softmax fc, top_k, log + the previous scores, beam_search and a
gather of the state by the parent rows; then stack and
beam_search_decode. Every step keeps B*K rows (finished beams are
frozen), so the decode program's shapes are fixed by the source LoD and
the engine captures it as one CUDA graph a LoD. The step parameters are
named (enc_*, dec_*, src_e, tgt_e, out_*), so the decode program runs in
the trained scope. The defaults are chapter 08's widths: dict 30000,
word 512, hidden 512; models/seq2seq.py's wmt14_batch makes the
training feeds.

The same two programs through the contrib decoder API
(contrib/decoder.py): contrib_train teacher-forces a TrainingDecoder
over a dense target of one length T (`tgt_in`, `tgt_lab` int64 [B, T]),
contrib_decode decodes with a BeamSearchDecoder. Their cell is the
decoder step above (the dec_* parameters); the beam decoder names its
embedding and softmax fc itself (CONTRIB_NAMES maps them to tgt_e,
out_w, out_b). On targets of one length the DynamicRNN of mt_train and
the TrainingDecoder's unroll run the same steps on the same rows.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..contrib.decoder import (BeamSearchDecoder, InitState, StateCell,
                               TrainingDecoder)
from ..core.scope import create_lod_tensor
from ..framework import Program, program_guard
from ..optimizer import AdamOptimizer
from ..param_attr import ParamAttr
from .seq2seq import wmt14_lengths

BOS, EOS = 1, 0


def _encoder(src, vocab, word_dim, hidden_dim):
    src_emb = layers.embedding(src, [vocab, word_dim],
                               param_attr=ParamAttr(name="src_e"))
    enc = layers.DynamicRNN()
    with enc.block():
        w = enc.step_input(src_emb)
        prev = enc.memory(shape=[hidden_dim], value=0.0)
        h = layers.fc([w, prev], hidden_dim, act="tanh",
                      param_attr=[ParamAttr(name="enc_wx"),
                                  ParamAttr(name="enc_wh")],
                      bias_attr=ParamAttr(name="enc_b"))
        enc.update_memory(prev, h)
        enc.output(h)
    return layers.sequence_last_step(enc())


def _dec_step_params():
    return dict(param_attr=[ParamAttr(name="dec_wx"),
                            ParamAttr(name="dec_wh")],
                bias_attr=ParamAttr(name="dec_b"))


def _softmax_fc(h, vocab):
    return layers.fc(h, vocab, act="softmax",
                     param_attr=ParamAttr(name="out_w"),
                     bias_attr=ParamAttr(name="out_b"))


def mt_train(lr=0.01, vocab=30000, word_dim=512, hidden_dim=512):
    """(main, startup, avg_cost) of the training program: feeds `src`,
    `tgt_in` and `tgt_lab` (int64, lod_level 1), AdamOptimizer(lr)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src", [1], dtype="int64", lod_level=1)
        tgt_in = layers.data("tgt_in", [1], dtype="int64", lod_level=1)
        tgt_lab = layers.data("tgt_lab", [1], dtype="int64", lod_level=1)
        enc_last = _encoder(src, vocab, word_dim, hidden_dim)
        tgt_emb = layers.embedding(tgt_in, [vocab, word_dim],
                                   param_attr=ParamAttr(name="tgt_e"))
        dec = layers.DynamicRNN()
        with dec.block():
            w = dec.step_input(tgt_emb)
            prev = dec.memory(init=enc_last, need_reorder=True)
            h = layers.fc([w, prev], hidden_dim, act="tanh",
                          **_dec_step_params())
            dec.update_memory(prev, h)
            dec.output(h)
        loss = layers.mean(layers.cross_entropy(_softmax_fc(dec(), vocab),
                                                tgt_lab))
        AdamOptimizer(lr).minimize(loss)
    return main, startup, loss


def mt_decode(vocab=30000, word_dim=512, hidden_dim=512, beam=4,
              max_len=80):
    """(program, sentence_ids, sentence_scores) of the beam-search
    decoder: feeds `src` (int64, lod_level 1), `init_ids` (int64 [B, 1],
    lod_level 2) and `init_scores` (float32 [B, 1]); the outputs are
    [B*beam, max_len] ids (end_id after each hypothesis's end) and
    [B*beam, 1] scores."""
    prog = Program()
    with program_guard(prog, Program()):
        src = layers.data("src", [1], dtype="int64", lod_level=1)
        init_ids = layers.data("init_ids", [1], dtype="int64", lod_level=2)
        init_scores = layers.data("init_scores", [1], dtype="float32")
        state = _encoder(src, vocab, word_dim, hidden_dim)     # [B, hidden]
        pre_ids, pre_scores = init_ids, init_scores
        ids_hist, score_hist, parent_hist = [], [], []
        for _ in range(max_len):
            emb = layers.embedding(pre_ids, [vocab, word_dim],
                                   param_attr=ParamAttr(name="tgt_e"))
            h = layers.fc([emb, state], hidden_dim, act="tanh",
                          **_dec_step_params())
            probs = _softmax_fc(h, vocab)
            topk_scores, topk_idx = layers.top_k(probs, k=beam)
            acc = layers.elementwise_add(layers.log(topk_scores),
                                         pre_scores)
            pre_ids, pre_scores, parent = layers.beam_search(
                pre_ids, pre_scores, topk_idx, acc, beam_size=beam,
                end_id=EOS, return_parent_idx=True)
            # the beam-permuted recurrent state
            state = layers.gather(h, parent)
            ids_hist.append(pre_ids)
            score_hist.append(pre_scores)
            parent_hist.append(parent)
        sent_ids, sent_scores = layers.beam_search_decode(
            layers.stack(ids_hist, axis=0), layers.stack(score_hist, axis=0),
            layers.stack(parent_hist, axis=0), beam_size=beam, end_id=EOS)
    return prog, sent_ids, sent_scores


def decode_feed(rng, batch, vocab, place=None, **lengths):
    """A decode feed of `batch` sources of random ids (0 and BOS kept
    out), lengths by wmt14_lengths(**lengths): `src`, `init_ids` (BOS,
    the two-level LoD of one row a source) and `init_scores` (zeros), on
    `place` (None: CUDAPlace(0))."""
    src_len = wmt14_lengths(rng, batch, **lengths)
    src = rng.integers(2, vocab, (int(src_len.sum()), 1))
    return {"src": create_lod_tensor(src, [src_len.tolist()], place),
            "init_ids": create_lod_tensor(np.full((batch, 1), BOS, np.int64),
                                          [[1] * batch] * 2, place),
            "init_scores": np.zeros((batch, 1), np.float32)}


def _cell(init, hidden_dim):
    """The decoder step as a StateCell: h = tanh(fc([x, h]))."""
    cell = StateCell(inputs={"x": None}, states={"h": InitState(init=init)},
                     out_state="h")

    @cell.state_updater
    def _step(c):
        c.set_state("h", layers.fc([c.get_input("x"), c.get_state("h")],
                                   hidden_dim, act="tanh",
                                   **_dec_step_params()))
    return cell


def contrib_train(lr=0.01, vocab=30000, word_dim=512, hidden_dim=512,
                  tgt_len=26):
    """(main, startup, avg_cost) of mt_train's model through the contrib
    API: feeds `src` (int64, lod_level 1), `tgt_in` and `tgt_lab` (int64
    [B, tgt_len]), AdamOptimizer(lr)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        src = layers.data("src", [1], dtype="int64", lod_level=1)
        tgt_in = layers.data("tgt_in", [tgt_len], dtype="int64")
        tgt_lab = layers.data("tgt_lab", [tgt_len], dtype="int64")
        enc_last = _encoder(src, vocab, word_dim, hidden_dim)
        tgt_emb = layers.embedding(tgt_in, [vocab, word_dim],
                                   param_attr=ParamAttr(name="tgt_e"))
        cell = _cell(enc_last, hidden_dim)
        dec = TrainingDecoder(cell)
        with dec.block():
            cell.compute_state({"x": dec.step_input(tgt_emb)})
            dec.output(cell.out_state())
            cell.update_states()
        h = layers.reshape(dec(), [-1, hidden_dim])
        lab = layers.reshape(tgt_lab, [-1, 1])
        loss = layers.mean(layers.cross_entropy(_softmax_fc(h, vocab), lab))
        AdamOptimizer(lr).minimize(loss)
    return main, startup, loss


# the beam decoder's own parameter names -> mt_decode's
CONTRIB_NAMES = {"beam_search_decoder_emb.w_0": "tgt_e",
                 "beam_search_decoder_fc.w_0": "out_w",
                 "beam_search_decoder_fc.b_0": "out_b"}


def contrib_decode(vocab=30000, word_dim=512, hidden_dim=512, beam=4,
                   max_len=80):
    """mt_decode's program through a BeamSearchDecoder (top `beam`
    candidates a step): the same feeds and outputs; its embedding and
    softmax fc read the parameters CONTRIB_NAMES names."""
    prog = Program()
    with program_guard(prog, Program()):
        src = layers.data("src", [1], dtype="int64", lod_level=1)
        init_ids = layers.data("init_ids", [1], dtype="int64", lod_level=2)
        init_scores = layers.data("init_scores", [1], dtype="float32")
        state = _encoder(src, vocab, word_dim, hidden_dim)
        dec = BeamSearchDecoder(
            _cell(state, hidden_dim), init_ids, init_scores,
            target_dict_dim=vocab, word_dim=word_dim, topk_size=beam,
            sparse_emb=False, max_len=max_len, beam_size=beam, end_id=EOS)
        dec.decode()
        sent_ids, sent_scores = dec()
    return prog, sent_ids, sent_scores


def dense_target_feed(rng, batch, vocab, tgt_len, place=None, **lengths):
    """A training feed of `batch` pairs whose targets all have tgt_len
    words: `src` (a LoDTensor, lengths by wmt14_lengths(**lengths)) and
    `tgt_in` / `tgt_lab` both as dense [batch, tgt_len] arrays
    (contrib_train's) and as LoDTensors of equal lengths (mt_train's):
    returns (contrib feed, mt_train feed)."""
    src_len = wmt14_lengths(rng, batch, **lengths)
    src = create_lod_tensor(rng.integers(2, vocab, (int(src_len.sum()), 1)),
                            [src_len.tolist()], place)
    tgt = rng.integers(2, vocab, (batch, tgt_len)).astype(np.int64)
    tgt_in = np.concatenate([np.full((batch, 1), BOS, np.int64),
                             tgt[:, :-1]], axis=1)
    lod = [[tgt_len] * batch]
    return ({"src": src, "tgt_in": tgt_in, "tgt_lab": tgt},
            {"src": src,
             "tgt_in": create_lod_tensor(tgt_in.reshape(-1, 1), lod, place),
             "tgt_lab": create_lod_tensor(tgt.reshape(-1, 1), lod, place)})
