"""The book models of tests/book/ in the port against the JAX package.

Each model is built by the same code in both packages at the widths of
its book test (fit_a_line, recognize_digits mlp and conv,
image_classification vgg and resnet, word2vec, recommender_system, and
the RNN encoder-decoder, which the port builds with
models/seq2seq.py). The port starts from the JAX package's initial
parameters (io.load_params_from_numpy), both train STEPS steps on the
same seeded feeds, and the losses and every parameter agree within
RTOL / ATOL. Then the port does the save / load / infer round trip of
tests/book/book_util.py: save_inference_model, load_inference_model in
a fresh scope, and the loaded program's outputs equal the live scope's;
the `__model__` it writes is the JAX package's byte for byte, the
encoder-decoder's with its two sub-blocks (the JAX package, without
64-bit types, infers int32 for accuracy's int64 outputs: those vars'
types are read as int64 first, _widen_int32).

The encoder-decoder is also served: AnalysisPredictor on LoD feeds
(src, tgt_in) equals the port's Executor, and a second run of the same
LoD replays its capture.

label_semantic_roles and machine_translation (models/
label_semantic_roles.py, models/machine_translation.py) are held the
same way at their book tests' widths, then decoded through both trained
scopes: the Viterbi paths equal; the beam decoder's ids equal but for
near-ties (counted and printed), its scores within DEC_RTOL / DEC_ATOL,
and the AnalysisPredictor serves it on a two-level LoD feed.
"""
import os
import struct

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core.scope import LoDTensor as JaxLoD
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.types import DT_INT32, DT_INT64
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.models import label_semantic_roles as srl
from paddle_tpu_torch.models import machine_translation as mt
from paddle_tpu_torch.models import seq2seq
from paddle_tpu_torch.proto import framework_desc as fd
from torch_threads import one_torch_thread  # noqa: F401

# The first loss (the same parameters and feed): FIRST_RTOL, worst
# measured 2.0e-7. Then the losses within RTOL and every persistable
# within RTOL / ATOL after STEPS steps. ATOL is 1 % of one Adam step at
# lr 2e-3: where an element's gradient is at the level of float32
# rounding, Adam's lr * m / (sqrt(v) + eps) magnifies the rounding to a
# fraction of a step (digits_mlp: one element of fc_0.w_0, 1.1e-5).
# image_vgg has one such element in fc_0.w_0 (its input is max-pooled
# relu outputs) that reaches 9.9e-5, 5 % of a step: its ATOL is 10 %.
#
# A relu whose input lies within rounding of 0 is a tie: the packages'
# inputs differ by up to 1.1e-5 (image_resnet, after batch_norm), so
# the two may take opposite sides of the gate. The gradient behind it
# then moves by a whole upstream gradient, and Adam's first steps
# (lr * sign(g) on a fresh moment) turn that into whole steps on the
# parameters (image_resnet, seed 11, first step: one element of
# conv2d_1.w_0 two steps apart). Such a step compares no code, so a
# step on which any relu gate differs between the packages, each
# differing input within TIE of 0, is undone in both and drawn anew (at
# most MAX_DRAWS a step). Measured: image_resnet 1 draw of 4 undone (its
# first, a relu input 1.2e-6 from 0), the other models none; the
# parameters then agree within the shared RTOL / ATOL, worst
# image_resnet 6.5e-6.
FIRST_RTOL = 1e-6
RTOL, ATOL = 1e-4, 2e-5
ATOLS = {"image_vgg": 2e-4}
TIE, MAX_DRAWS = 1e-4, 8
STEPS = 3


def _fit_a_line(fl, L):
    x = L.data("x", [13], dtype="float32")
    y = L.data("y", [1], dtype="float32")
    pred = L.fc(x, 1)
    loss = L.mean(L.square_error_cost(pred, y))
    fl.optimizer.SGDOptimizer(0.02).minimize(loss)
    return loss, pred, ["x"]


def _digits(net):
    def build(fl, L):
        img = L.data("img", [1, 28, 28], dtype="float32")
        label = L.data("label", [1], dtype="int64")
        if net == "mlp":
            h = L.fc(L.fc(img, 64, act="relu"), 64, act="relu")
        else:
            h = L.pool2d(L.conv2d(img, 8, 5, act="relu"), 2, "max", 2)
            h = L.pool2d(L.conv2d(h, 16, 5, act="relu"), 2, "max", 2)
        pred = L.fc(h, 10, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        L.accuracy(pred, label)
        fl.optimizer.AdamOptimizer(2e-3).minimize(loss)
        return loss, pred, ["img"]
    return build


def _image(net):
    def build(fl, L):
        img = L.data("img", [3, 32, 32], dtype="float32")
        label = L.data("label", [1], dtype="int64")
        if net == "vgg":
            h = img
            for ch in (8, 16):
                c = L.conv2d(h, ch, 3, padding=1, act="relu")
                c = L.conv2d(c, ch, 3, padding=1, act="relu")
                h = L.pool2d(c, 2, "max", 2)
            h = L.fc(h, 64, act="relu")
        else:
            def conv_bn(x, ch, stride=1, act="relu"):
                c = L.conv2d(x, ch, 3, stride=stride, padding=1,
                             bias_attr=False)
                return L.batch_norm(c, act=act)

            def basic(x, ch, stride=1):
                c = conv_bn(conv_bn(x, ch, stride), ch, act=None)
                if stride != 1 or x.shape[1] != ch:
                    x = conv_bn(x, ch, stride, act=None)
                return L.relu(L.elementwise_add(c, x))

            h = basic(basic(conv_bn(img, 8), 8), 16, stride=2)
            h = L.pool2d(h, 4, "avg", 4)
        pred = L.fc(h, 4, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        fl.optimizer.AdamOptimizer(2e-3).minimize(loss)
        return loss, pred, ["img"]
    return build


def _word2vec(fl, L):
    words = [L.data(f"w{i}", [1], dtype="int64") for i in range(4)]
    target = L.data("tgt", [1], dtype="int64")
    embs = [L.embedding(w, size=[32, 16], is_sparse=True,
                        param_attr=fl.ParamAttr(name="shared_w"))
            for w in words]
    hidden = L.fc(L.concat(embs, axis=1), 128, act="relu")
    pred = L.fc(hidden, 32, act="softmax")
    loss = L.mean(L.cross_entropy(pred, target))
    fl.optimizer.AdamOptimizer(0.01).minimize(loss)
    return loss, pred, ["w0", "w1", "w2", "w3"]


def _recommender(fl, L):
    names = ("uid", "job", "age", "mid", "cat")
    ids = {n: L.data(n, [1], dtype="int64") for n in names}
    score = L.data("score", [1], dtype="float32")
    usr = L.fc(L.concat([L.embedding(ids["uid"], [24, 16]),
                         L.embedding(ids["job"], [5, 4]),
                         L.embedding(ids["age"], [7, 4])], axis=1),
               32, act="tanh")
    mov = L.fc(L.concat([L.embedding(ids["mid"], [30, 16]),
                         L.embedding(ids["cat"], [6, 4])], axis=1),
               32, act="tanh")
    pred = L.scale(L.cos_sim(usr, mov), scale=5.0)
    loss = L.mean(L.square_error_cost(pred, score))
    fl.optimizer.AdamOptimizer(5e-3).minimize(loss)
    return loss, pred, list(names)


def _feeds(name, rng):
    if name == "fit_a_line":
        x = rng.standard_normal((32, 13)).astype(np.float32)
        return {"x": x, "y": x[:, :1] * 0.5}
    if name.startswith("digits"):
        return {"img": rng.standard_normal((16, 1, 28, 28))
                .astype(np.float32),
                "label": rng.integers(0, 10, (16, 1)).astype(np.int64)}
    if name.startswith("image"):
        return {"img": rng.standard_normal((8, 3, 32, 32))
                .astype(np.float32),
                "label": rng.integers(0, 4, (8, 1)).astype(np.int64)}
    if name == "word2vec":
        ctx = rng.integers(0, 32, (64, 4))
        feed = {f"w{i}": ctx[:, i:i + 1].astype(np.int64)
                for i in range(4)}
        feed["tgt"] = ((ctx[:, 0] + ctx[:, 1]) % 32).reshape(-1, 1) \
            .astype(np.int64)
        return feed
    us, it = rng.integers(0, 24, 64), rng.integers(0, 30, 64)
    return {"uid": us.reshape(-1, 1), "job": (us % 5).reshape(-1, 1),
            "age": (us % 7).reshape(-1, 1), "mid": it.reshape(-1, 1),
            "cat": (it % 6).reshape(-1, 1),
            "score": rng.uniform(0, 5, (64, 1)).astype(np.float32)}


MODELS = {"fit_a_line": _fit_a_line, "digits_mlp": _digits("mlp"),
          "digits_conv": _digits("conv"), "image_vgg": _image("vgg"),
          "image_resnet": _image("resnet"), "word2vec": _word2vec,
          "recommender": _recommender}


def _build(fl, build):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        loss, pred, feeds = build(fl, fl.layers)
    return main, startup, loss, pred, feeds


def _persistables(prog, scope):
    return {v.name: np.asarray(scope.find_var(v.name).get_tensor())
            for v in prog.global_block().vars.values()
            if v.persistable and scope.find_var(v.name) is not None}


def _restore(scope, state, place=None):
    for name, arr in state.items():
        scope.find_var(name).get_tensor().set(arr, place)


def _train_both(jmain, jstart, jloss, pmain, pstart, ploss, draw,
                atol=ATOL):
    """STEPS steps in each package from the JAX package's initial
    parameters, each on the (jax feed, port feed) pair `draw()` gives,
    a step whose relu gates differ undone and drawn anew; returns (jax
    scope, port scope, port executor)."""
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    gates = [op.input("X")[0] for op in jmain.global_block().ops
             if op.type == "relu"]
    for k in range(STEPS):
        before = (_persistables(jmain, jscope),
                  _persistables(pmain, pscope))
        for _ in range(MAX_DRAWS):
            jf, pf = draw()
            jl, *jg = jexe.run(jmain, feed=jf, fetch_list=[jloss] + gates,
                               scope=jscope)
            pl, *pg = pexe.run(pmain, feed=pf, fetch_list=[ploss] + gates,
                               scope=pscope)
            ties = np.concatenate(
                [np.abs(j)[(j > 0) != (p > 0)] for j, p in
                 ((np.asarray(j), np.asarray(p)) for j, p in zip(jg, pg))]
                + [np.zeros(0, np.float32)])
            assert (ties < TIE).all(), ties.max()
            if not ties.size:
                break
            _restore(jscope, before[0])
            _restore(pscope, before[1], pt.CPUPlace())
        else:
            pytest.fail(f"step {k}: the relu gates differ on every draw")
        np.testing.assert_allclose(np.asarray(pl), np.asarray(jl),
                                   rtol=RTOL if k else FIRST_RTOL)
    jp, pp = _persistables(jmain, jscope), _persistables(pmain, pscope)
    assert set(pp) == set(jp)
    for n in jp:
        np.testing.assert_allclose(pp[n], jp[n], rtol=RTOL, atol=atol,
                                   err_msg=n)
    return jscope, pscope, pexe


def _round_trip(tmp_path, pscope, pexe, pmain, feed_names, pred, feed,
                jscope, jmain, jpred, int_vars=("accuracy",)):
    """book_util.save_load_infer_roundtrip in the port, and the
    __model__ against the JAX package's."""
    d = str(tmp_path / "pt")
    with pt.scope_guard(pscope):
        pt.io.save_inference_model(d, feed_names, [pred], pexe,
                                   main_program=pmain)
        prog, _, fetch = pt.io.load_inference_model(d, pexe)
        want = pexe.run(prog, feed=feed, fetch_list=fetch)
    fresh = pt.Scope()
    with pt.scope_guard(fresh):
        exe2 = pt.Executor(pt.CPUPlace())
        prog2, names2, fetch2 = pt.io.load_inference_model(d, exe2)
        assert list(names2) == list(feed_names)
        got = exe2.run(prog2, feed=feed, fetch_list=fetch2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    jd = str(tmp_path / "jax")
    with fluid.scope_guard(jscope):
        fluid.io.save_inference_model(jd, feed_names, [jpred],
                                      fluid.Executor(fluid.CPUPlace()),
                                      main_program=jmain)
    with open(os.path.join(d, "__model__"), "rb") as a, \
            open(os.path.join(jd, "__model__"), "rb") as b:
        mine, theirs = a.read(), b.read()
    assert mine == _widen_int32(theirs, mine, int_vars)
    return d, got


def _widen_int32(theirs, mine, int_vars=("accuracy",)):
    """The JAX package's __model__ with the int32 var types that its
    32-bit mode infers for int64 outputs (accuracy's; `int_vars` names
    the prefixes allowed) written as the port's int64 (no other var may
    differ in type)."""
    head = 8 + struct.unpack("<I", theirs[4:8])[0]
    return theirs[:head] + _widen_desc(theirs[head:], mine[head:],
                                       int_vars)


def _widen_desc(theirs, mine, int_vars):
    """_widen_int32 on ProgramDesc bytes."""
    j = fd.ProgramDesc.FromString(theirs)
    p = fd.ProgramDesc.FromString(mine)
    for jb, pb in zip(j.blocks, p.blocks):
        for jv, pv in zip(jb.vars, pb.vars):
            if (jv.tensor.data_type, pv.tensor.data_type) == \
                    (DT_INT32, DT_INT64):
                assert jv.name.startswith(int_vars), jv.name
                jv.tensor.data_type = DT_INT64
    return j.SerializeToString()


def _same_ops(pmain, jmain):
    """Op for op: types, inputs, outputs, attrs, and the parameters'
    shapes. (The training programs' descs differ in one place: the JAX
    package, without 64-bit types, infers int32 for accuracy's int64
    outputs; the inference __model__ has none of those and is compared
    byte for byte.)"""
    for pb, jb in zip(pmain.blocks, jmain.blocks):
        assert [o.type for o in pb.ops] == [o.type for o in jb.ops]
        for p, j in zip(pb.ops, jb.ops):
            assert (p._inputs, p._outputs, p.all_attrs()) == \
                (j._inputs, j._outputs, j.all_attrs()), p.type
    assert [(p.name, tuple(p.shape)) for p in pmain.all_parameters()] == \
        [(p.name, tuple(p.shape)) for p in jmain.all_parameters()]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_book_model_matches_jax(tmp_path, name):
    jmain, jstart, jloss, jpred, feed_names = _build(fluid, MODELS[name])
    pmain, pstart, ploss, ppred, _ = _build(pt, MODELS[name])
    _same_ops(pmain, jmain)
    rng = np.random.default_rng(11)

    def draw():
        feed = _feeds(name, rng)
        return feed, feed

    jscope, pscope, pexe = _train_both(jmain, jstart, jloss, pmain,
                                       pstart, ploss, draw,
                                       ATOLS.get(name, ATOL))
    infer = {n: a for n, a in _feeds(name, rng).items()
             if n in feed_names}
    _round_trip(tmp_path, pscope, pexe, pmain, feed_names, ppred, infer,
                jscope, jmain, jpred)


# ---------------------------------------------------------------------------
# the RNN encoder-decoder
# ---------------------------------------------------------------------------

VOCAB, EMB, HID = 8, 16, 48


def _jax_seq2seq():
    """tests/book/test_rnn_encoder_decoder.py's _model, widths as
    arguments."""
    L = fluid.layers
    src = L.data("src", [1], dtype="int64", lod_level=1)
    tgt_in = L.data("tgt_in", [1], dtype="int64", lod_level=1)
    tgt_lab = L.data("tgt_lab", [1], dtype="int64", lod_level=1)
    src_emb = L.embedding(src, [VOCAB, EMB],
                          param_attr=fluid.ParamAttr(name="src_e"))
    enc = L.DynamicRNN()
    with enc.block():
        w = enc.step_input(src_emb)
        prev = enc.memory(shape=[HID], value=0.0)
        h = L.fc([w, prev], HID, act="tanh")
        enc.update_memory(prev, h)
        enc.output(h)
    enc_last = L.sequence_last_step(enc())
    tgt_emb = L.embedding(tgt_in, [VOCAB, EMB],
                          param_attr=fluid.ParamAttr(name="tgt_e"))
    dec = L.DynamicRNN()
    with dec.block():
        w = dec.step_input(tgt_emb)
        prev = dec.memory(init=enc_last, need_reorder=True)
        h = L.fc([w, prev], HID, act="tanh")
        dec.update_memory(prev, h)
        dec.output(h)
    logits = L.fc(dec(), VOCAB, act="softmax",
                  param_attr=fluid.ParamAttr(name="out_w"),
                  bias_attr=fluid.ParamAttr(name="out_b"))
    loss = L.mean(L.cross_entropy(logits, tgt_lab))
    fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return loss, logits


def _seq2seq_feeds(seed, n, batch=5):
    """`n` (jax feed, port feed) pairs of WMT14-shaped batches, lengths
    scaled to the tiny width (median 4, in [1, 9])."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pf = seq2seq.wmt14_batch(rng, batch, VOCAB, VOCAB,
                                 place=pt.CPUPlace(), median=4.0, lo=1,
                                 hi=9)
        jf = {k: JaxLoD(np.asarray(v), v.lod()) for k, v in pf.items()}
        out.append((jf, pf))
    return out


def test_seq2seq_matches_jax_and_serves(tmp_path):
    fluid.framework.unique_name.reset()
    jmain, jstart = fluid.Program(), fluid.Program()
    with fluid.program_guard(jmain, jstart):
        jloss, jlogits = _jax_seq2seq()
    pt.framework.unique_name.reset()
    pmain, pstart, ploss, plogits = seq2seq.seq2seq_train(
        src_vocab=VOCAB, tgt_vocab=VOCAB, word_dim=EMB, hidden_dim=HID)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert len(pmain.blocks) == 3
    jscope, pscope, pexe = _train_both(
        jmain, jstart, jloss, pmain, pstart, ploss,
        iter(_seq2seq_feeds(5, STEPS)).__next__)
    (_, infer), = _seq2seq_feeds(9, 1)
    infer = {k: infer[k] for k in ("src", "tgt_in")}
    d, got = _round_trip(tmp_path, pscope, pexe, pmain, ["src", "tgt_in"],
                         plogits, infer, jscope, jmain, jlogits)
    config = AnalysisConfig(d)
    config.disable_gpu()
    predictor = create_paddle_predictor(config)
    for name in ("src", "tgt_in"):
        it = predictor.get_input_tensor(name)
        it.copy_from_cpu(np.asarray(infer[name]))
        it.set_lod(infer[name].lod())
    for _ in range(3):
        predictor.zero_copy_run()
        out = predictor.get_output_tensor(predictor.get_output_names()[0])
        np.testing.assert_array_equal(out.copy_to_cpu(),
                                      np.asarray(got[0]))
    c = predictor._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 1), c


# ---------------------------------------------------------------------------
# label_semantic_roles: the CRF tagger, trained, then Viterbi-decoded
# ---------------------------------------------------------------------------

SRL = {"vocab": 16, "n_tag": 4, "emb_dim": 16, "hidden_dim": 32}
SRL_B = 8


def _jax_emission(word):
    """tests/book/test_label_semantic_roles.py's _emission_net."""
    L = fluid.layers
    emb = L.embedding(word, [SRL["vocab"], SRL["emb_dim"]],
                      param_attr=fluid.ParamAttr(name="w_emb"))
    drnn = L.DynamicRNN()
    with drnn.block():
        w = drnn.step_input(emb)
        prev = drnn.memory(shape=[SRL["hidden_dim"]], value=0.0)
        h = L.fc([w, prev], SRL["hidden_dim"], act="tanh",
                 param_attr=[fluid.ParamAttr(name="r_wx"),
                             fluid.ParamAttr(name="r_wh")],
                 bias_attr=fluid.ParamAttr(name="r_b"))
        drnn.update_memory(prev, h)
        drnn.output(h)
    return L.fc(drnn(), SRL["n_tag"], param_attr=fluid.ParamAttr(name="em_w"),
                bias_attr=fluid.ParamAttr(name="em_b"))


def _jax_srl():
    """(main, startup, loss, decode program, path) as the JAX book test
    builds them."""
    L = fluid.layers
    fluid.framework.unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        word = L.data("word", [1], dtype="int64", lod_level=1)
        tag = L.data("tag", [1], dtype="int64", lod_level=1)
        cost = L.linear_chain_crf(_jax_emission(word), tag,
                                  param_attr=fluid.ParamAttr(name="crfw"))
        loss = L.mean(cost)
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    decode = fluid.Program()
    with fluid.program_guard(decode, fluid.Program()):
        word = L.data("word", [1], dtype="int64", lod_level=1)
        with pytest.warns(UserWarning, match="crfw"):
            path = L.crf_decoding(_jax_emission(word),
                                  fluid.ParamAttr(name="crfw"))
    return main, startup, loss, decode, path


def _lod_pairs(feeds):
    return [({k: JaxLoD(np.asarray(v), v.lod()) for k, v in f.items()}, f)
            for f in feeds]


def test_label_semantic_roles_matches_jax(tmp_path):
    """The same programs (training, its startup and the decode program:
    ProgramDesc bytes), 3 Adam steps from the JAX package's parameters on
    synthetic CoNLL-05 batches, then the Viterbi paths of a new batch
    through both trained scopes equal, with the feed's LoD; the decode
    program round-trips as an inference model (__model__ bytes)."""
    jmain, jstart, jloss, jdecode, jpath = _jax_srl()
    pt.framework.unique_name.reset()
    pmain, pstart, ploss, _ = srl.srl_train(**SRL)
    with pytest.warns(UserWarning, match="crfw"):
        pdecode, ppath = srl.srl_decode(**SRL)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    assert pdecode.serialize_to_string() == jdecode.serialize_to_string()
    rng = np.random.default_rng(7)
    pairs = _lod_pairs([srl.conll05_batch(rng, SRL_B, SRL["vocab"],
                                          SRL["n_tag"], pt.CPUPlace())
                        for _ in range(STEPS + 1)])
    jscope, pscope, pexe = _train_both(jmain, jstart, jloss, pmain, pstart,
                                       ploss, iter(pairs[:STEPS]).__next__)
    jf, pf = pairs[STEPS]
    jf, pf = {"word": jf["word"]}, {"word": pf["word"]}
    want, = fluid.Executor(fluid.CPUPlace()).run(
        jdecode, feed=jf, fetch_list=[jpath], scope=jscope)
    got, = pexe.run(pdecode, feed=pf, fetch_list=[ppath], scope=pscope)
    assert np.asarray(got).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert got.lod() == pf["word"].lod()
    _round_trip(tmp_path, pscope, pexe, pdecode, ["word"], ppath, pf,
                jscope, jdecode, jpath)


# ---------------------------------------------------------------------------
# machine_translation: the seq2seq, trained, then beam-search decoded
# ---------------------------------------------------------------------------

MT = {"vocab": 10, "word_dim": 16, "hidden_dim": 48}
MT_BEAM, MT_LEN, MT_SOURCES = 3, 4, 5
# the beam decode's scores (sums of MT_LEN log-probabilities) after 3
# Adam steps in each package: within DEC_RTOL / DEC_ATOL (measured worst
# 1.4e-6 absolute, no near-tie); two hypotheses whose JAX scores lie
# within DEC_ATOL of each other may swap (a near-tie)
DEC_RTOL, DEC_ATOL = 1e-4, 1e-5
# the decode program's vars that the JAX package infers int32: top_k's
# indices, the stacked ids and the decoded sentences
_MT_INT_VARS = ("top_k", "stack", "beam_search_decode")


def _jax_mt_encoder(src):
    L = fluid.layers
    src_emb = L.embedding(src, [MT["vocab"], MT["word_dim"]],
                          param_attr=fluid.ParamAttr(name="src_e"))
    enc = L.DynamicRNN()
    with enc.block():
        w = enc.step_input(src_emb)
        prev = enc.memory(shape=[MT["hidden_dim"]], value=0.0)
        h = L.fc([w, prev], MT["hidden_dim"], act="tanh",
                 param_attr=[fluid.ParamAttr(name="enc_wx"),
                             fluid.ParamAttr(name="enc_wh")],
                 bias_attr=fluid.ParamAttr(name="enc_b"))
        enc.update_memory(prev, h)
        enc.output(h)
    return L.sequence_last_step(enc())


def _jax_mt_step(L, w, prev):
    return L.fc([w, prev], MT["hidden_dim"], act="tanh",
                param_attr=[fluid.ParamAttr(name="dec_wx"),
                            fluid.ParamAttr(name="dec_wh")],
                bias_attr=fluid.ParamAttr(name="dec_b"))


def _jax_mt_probs(L, h):
    return L.fc(h, MT["vocab"], act="softmax",
                param_attr=fluid.ParamAttr(name="out_w"),
                bias_attr=fluid.ParamAttr(name="out_b"))


def _jax_mt():
    """tests/book/test_machine_translation.py's _train_net (with Adam)
    and _decode_net: (main, startup, loss, decode, ids, scores)."""
    L = fluid.layers
    fluid.framework.unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = L.data("src", [1], dtype="int64", lod_level=1)
        tgt_in = L.data("tgt_in", [1], dtype="int64", lod_level=1)
        tgt_lab = L.data("tgt_lab", [1], dtype="int64", lod_level=1)
        enc_last = _jax_mt_encoder(src)
        tgt_emb = L.embedding(tgt_in, [MT["vocab"], MT["word_dim"]],
                              param_attr=fluid.ParamAttr(name="tgt_e"))
        dec = L.DynamicRNN()
        with dec.block():
            w = dec.step_input(tgt_emb)
            prev = dec.memory(init=enc_last, need_reorder=True)
            h = _jax_mt_step(L, w, prev)
            dec.update_memory(prev, h)
            dec.output(h)
        loss = L.mean(L.cross_entropy(_jax_mt_probs(L, dec()), tgt_lab))
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    decode = fluid.Program()
    with fluid.program_guard(decode, fluid.Program()):
        src = L.data("src", [1], dtype="int64", lod_level=1)
        pre_ids = L.data("init_ids", [1], dtype="int64", lod_level=2)
        pre_scores = L.data("init_scores", [1], dtype="float32")
        state = _jax_mt_encoder(src)
        hist = ([], [], [])
        for _ in range(MT_LEN):
            emb = L.embedding(pre_ids, [MT["vocab"], MT["word_dim"]],
                              param_attr=fluid.ParamAttr(name="tgt_e"))
            h = _jax_mt_step(L, emb, state)
            top_sc, top_idx = L.top_k(_jax_mt_probs(L, h), k=MT_BEAM)
            acc = L.elementwise_add(L.log(top_sc), pre_scores)
            pre_ids, pre_scores, parent = L.beam_search(
                pre_ids, pre_scores, top_idx, acc, beam_size=MT_BEAM,
                end_id=mt.EOS, return_parent_idx=True)
            state = L.gather(h, parent)
            for lst, v in zip(hist, (pre_ids, pre_scores, parent)):
                lst.append(v)
        ids, scores = L.beam_search_decode(
            *[L.stack(lst, axis=0) for lst in hist], beam_size=MT_BEAM,
            end_id=mt.EOS)
    return main, startup, loss, decode, ids, scores


def _near_ties(want_ids, want_sc, got_ids, got_sc):
    """The hypotheses (rows) whose ids differ between the packages. Each
    must be a near-tie: the port's row is another of the source's JAX
    rows whose JAX score lies within DEC_ATOL of this row's, or (a tie at
    the beam's cut) a hypothesis the JAX decode left out whose port score
    lies within DEC_ATOL of this row's JAX score. Returns the rows."""
    rows = []
    for r in np.flatnonzero((want_ids != got_ids).any(1)):
        group = range(r - r % MT_BEAM, r - r % MT_BEAM + MT_BEAM)
        same = [q for q in group if (want_ids[q] == got_ids[r]).all()]
        other = want_sc[same[0]] if same else got_sc[r]
        assert abs(float(other) - float(want_sc[r])) <= DEC_ATOL, (
            f"hypothesis {r}: {got_ids[r]} (port) against {want_ids[r]} "
            f"(JAX) is no near-tie: scores {float(other)} and "
            f"{float(want_sc[r])}")
        rows.append(int(r))
    return rows


def test_machine_translation_matches_jax_and_serves(tmp_path):
    """The same training and decode programs (ProgramDesc bytes; the JAX
    package infers int32 where the port keeps int64 ids, _widen_int32),
    3 Adam steps from the JAX package's parameters on WMT14-shaped
    batches, then a beam decode of MT_SOURCES new sources through both
    trained scopes: SentenceIds equal but for near-ties (counted and
    printed), SentenceScores within DEC_RTOL / DEC_ATOL. The decode
    program round-trips as an inference model, and AnalysisPredictor
    serves it on the two-level LoD feed: its ids and scores equal the
    Executor's, a second run replays its capture."""
    jmain, jstart, jloss, jdecode, jids, jsc = _jax_mt()
    pt.framework.unique_name.reset()
    pmain, pstart, ploss = mt.mt_train(**MT)
    pdecode, pids, psc = mt.mt_decode(beam=MT_BEAM, max_len=MT_LEN, **MT)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert pstart.serialize_to_string() == jstart.serialize_to_string()
    mine = pdecode.serialize_to_string()
    assert mine == _widen_desc(jdecode.serialize_to_string(), mine,
                               _MT_INT_VARS)
    rng = np.random.default_rng(5)
    pairs = _lod_pairs([seq2seq.wmt14_batch(
        rng, 6, MT["vocab"], MT["vocab"], place=pt.CPUPlace(), median=4.0,
        lo=1, hi=9) for _ in range(STEPS)])
    jscope, pscope, pexe = _train_both(jmain, jstart, jloss, pmain, pstart,
                                       ploss, iter(pairs).__next__)
    pf = mt.decode_feed(np.random.default_rng(9), MT_SOURCES, MT["vocab"],
                        pt.CPUPlace(), median=3.0, lo=2, hi=6)
    jf = {"src": JaxLoD(np.asarray(pf["src"]), pf["src"].lod()),
          "init_ids": JaxLoD(np.asarray(pf["init_ids"]),
                             pf["init_ids"].lod()),
          "init_scores": pf["init_scores"]}
    want = [np.asarray(v) for v in fluid.Executor(fluid.CPUPlace()).run(
        jdecode, feed=jf, fetch_list=[jids, jsc], scope=jscope)]
    got = [np.asarray(v) for v in pexe.run(
        pdecode, feed=pf, fetch_list=[pids, psc], scope=pscope)]
    assert got[0].dtype == np.int32
    assert got[0].shape == (MT_SOURCES * MT_BEAM, MT_LEN)
    ties = _near_ties(want[0], want[1], got[0], got[1])
    print(f"machine_translation: {len(ties)} near-ties of "
          f"{len(got[0])} hypotheses {ties}; max |score diff| "
          f"{float(np.abs(got[1] - want[1]).max()):.3e}")
    keep = [r for r in range(len(got[0])) if r not in ties]
    np.testing.assert_allclose(got[1][keep], want[1][keep], rtol=DEC_RTOL,
                               atol=DEC_ATOL)
    d, served = _round_trip(tmp_path, pscope, pexe, pdecode,
                            ["src", "init_ids", "init_scores"], pids, pf,
                            jscope, jdecode, jids, _MT_INT_VARS)
    np.testing.assert_array_equal(np.asarray(served[0]), got[0])
    config = AnalysisConfig(d)
    config.disable_gpu()
    predictor = create_paddle_predictor(config)
    for name in ("src", "init_ids", "init_scores"):
        it = predictor.get_input_tensor(name)
        it.copy_from_cpu(np.asarray(pf[name]))
        if name != "init_scores":
            it.set_lod(pf[name].lod())
    for _ in range(3):
        predictor.zero_copy_run()
        out = predictor.get_output_tensor(predictor.get_output_names()[0])
        np.testing.assert_array_equal(out.copy_to_cpu(), got[0])
    c = predictor._engine.counters
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 1), c
