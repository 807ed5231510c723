"""The contrib decoder API (contrib/decoder.py) in the port against the
JAX package, and the book's machine translation model built through it
against the port's own mt_train / mt_decode.

* The tiny beam decoder of tests/test_contrib_beam_decoder.py (vocab 7,
  word 4, hidden 6, beam 2, 3 steps), built in both packages: the same
  ProgramDesc bytes (the JAX package writes int32 where the port keeps
  int64 ids), and from the JAX package's parameters the same ids and
  scores within TOL; in the port it also equals the hand-built
  primitive pipeline bit for bit.
* A TrainingDecoder (the dense unroll, a StateCell with a derived
  state) in both packages: the forward and 3 Adam steps from the JAX
  parameters within TOL.
* contrib_train against mt_train on targets of one length: 4 Adam
  losses bit-equal; contrib_decode against mt_decode from the same
  trained parameters: ids and scores bit-equal (on the card the same
  checks run at chapter 08's widths in chip_smoke.py).
* The API's misuse errors, as the JAX package raises them.

Tolerance: TOL = 1e-5 relative and absolute against the JAX package
(float32 sums in other orders); the port against itself exact.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core.scope import LoDTensor as JaxLoD
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.models import machine_translation as mt

from test_torch_book import _widen_desc
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
V, E, HID = 7, 4, 6
B, BEAM, MAX_LEN, TOPK = 2, 2, 3, 4
EOS = 0
CPU = pt.CPUPlace()


def _updater_params(fl):
    return dict(param_attr=[fl.ParamAttr(name="u_wx"),
                            fl.ParamAttr(name="u_wh")],
                bias_attr=fl.ParamAttr(name="u_b"))


def _cell(fl, h0):
    C = fl.contrib.decoder
    cell = C.StateCell(inputs={"x": None},
                       states={"h": C.InitState(init=h0)}, out_state="h")

    @cell.state_updater
    def updater(c):
        c.set_state("h", fl.layers.fc([c.get_input("x"), c.get_state("h")],
                                      HID, act="tanh",
                                      **_updater_params(fl)))
    return cell


def _decoder_program(fl):
    fl.framework.unique_name.reset()
    prog, startup = fl.Program(), fl.Program()
    L = fl.layers
    with fl.program_guard(prog, startup):
        h0 = L.data("h0", [HID], dtype="float32")
        init_ids = L.data("init_ids", [1], dtype="int64", lod_level=2)
        init_scores = L.data("init_scores", [1], dtype="float32")
        decoder = fl.contrib.decoder.BeamSearchDecoder(
            _cell(fl, h0), init_ids, init_scores, target_dict_dim=V,
            word_dim=E, topk_size=TOPK, sparse_emb=False, max_len=MAX_LEN,
            beam_size=BEAM, end_id=EOS)
        decoder.decode()
        ids, scores = decoder()
    return prog, startup, ids, scores


def _golden_program():
    """The port's primitives by hand, with the decoder's names."""
    pt.framework.unique_name.reset()
    prog = pt.Program()
    L = pt.layers
    with pt.program_guard(prog, pt.Program()):
        h0 = L.data("h0", [HID], dtype="float32")
        prev_ids = L.data("init_ids", [1], dtype="int64", lod_level=2)
        prev_scores = L.data("init_scores", [1], dtype="float32")
        h, hist = h0, ([], [], [])
        for _ in range(MAX_LEN):
            emb = L.embedding(prev_ids, size=[V, E], dtype="float32",
                              param_attr=pt.ParamAttr(
                                  name="beam_search_decoder_emb.w_0"))
            h = L.fc([emb, h], HID, act="tanh", **_updater_params(pt))
            probs = L.fc(h, V, act="softmax", param_attr=pt.ParamAttr(
                name="beam_search_decoder_fc.w_0"), bias_attr=pt.ParamAttr(
                name="beam_search_decoder_fc.b_0"))
            top_scores, top_idx = L.topk(probs, k=TOPK)
            accu = L.elementwise_add(L.log(top_scores), prev_scores)
            prev_ids, prev_scores, parent = L.beam_search(
                prev_ids, prev_scores, top_idx, accu, BEAM, end_id=EOS,
                return_parent_idx=True)
            h = L.gather(h, parent)
            for lst, v in zip(hist, (prev_ids, prev_scores, parent)):
                lst.append(v)
        ids, scores = L.beam_search_decode(
            *[L.stack(x, axis=0) for x in hist], beam_size=BEAM,
            end_id=EOS)
    return prog, ids, scores


def _feeds(lod_cls):
    rng = np.random.default_rng(0)
    lod2 = [list(range(B + 1)), list(range(B + 1))]
    ids = np.full((B, 1), 2, np.int64)
    return {"h0": rng.standard_normal((B, HID)).astype(np.float32),
            "init_ids": lod_cls(ids, lod2),
            "init_scores": np.zeros((B, 1), np.float32)}


def _jax_params(prog, startup):
    scope = JaxScope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return scope, {p.name: np.asarray(scope.find_var(p.name).get_tensor())
                   for p in prog.all_parameters()}


def test_beam_search_decoder_matches_jax():
    jprog, jstart, jids, jsc = _decoder_program(fluid)
    pprog, pstart, pids, psc = _decoder_program(pt)
    mine = pprog.serialize_to_string()
    assert mine == _widen_desc(jprog.serialize_to_string(), mine,
                               ("top_k", "stack", "beam_search_decode"))
    jscope, params = _jax_params(jprog, jstart)
    want = fluid.Executor(fluid.CPUPlace()).run(
        jprog, feed=_feeds(JaxLoD), fetch_list=[jids, jsc], scope=jscope)
    pscope = pt.Scope()
    load_params_from_numpy(pscope, params, CPU)
    got = pt.Executor(CPU).run(pprog, feed=_feeds(
        lambda a, lod: pt.create_lod_tensor(a, [
            np.diff(lv).tolist() for lv in lod], CPU)),
        fetch_list=[pids, psc], scope=pscope)
    assert got[0].shape == (B * BEAM, MAX_LEN)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=TOL,
                               atol=TOL)
    gprog, gids, gsc = _golden_program()
    gold = pt.Executor(CPU).run(gprog, feed=_feeds(
        lambda a, lod: pt.create_lod_tensor(a, [
            np.diff(lv).tolist() for lv in lod], CPU)),
        fetch_list=[gids, gsc], scope=pscope)
    for a, b in zip(got, gold):
        np.testing.assert_array_equal(a, b)


T_LEN = 4


def _training_program(fl):
    """A TrainingDecoder over a dense [B, T_LEN, E] input whose output
    is a derived state (set in the updater), mean-squared against a
    target, Adam."""
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    L = fl.layers
    C = fl.contrib.decoder
    with fl.program_guard(main, startup):
        x = L.data("x", [T_LEN, E], dtype="float32")
        y = L.data("y", [T_LEN, 1], dtype="float32")
        h0 = L.data("h0", [HID], dtype="float32")
        cell = C.StateCell(inputs={"x": None},
                           states={"h": C.InitState(init=h0)},
                           out_state="h")

        @cell.state_updater
        def updater(c):
            h = L.fc([c.get_input("x"), c.get_state("h")], HID,
                     act="tanh", **_updater_params(fl))
            c.set_state("h", h)
            c.set_state("o", L.fc(h, 1, param_attr=fl.ParamAttr(
                name="o_w"), bias_attr=fl.ParamAttr(name="o_b")))

        dec = C.TrainingDecoder(cell)
        with dec.block():
            cell.compute_state({"x": dec.step_input(x)})
            dec.output(cell.get_state("o"))
            cell.update_states()
        out = dec()
        loss = L.mean(L.square_error_cost(out, y))
        fl.optimizer.AdamOptimizer(0.05).minimize(loss)
    return main, startup, loss, out


def test_training_decoder_matches_jax():
    rng = np.random.default_rng(1)
    feed = {"x": rng.standard_normal((3, T_LEN, E)).astype(np.float32),
            "y": rng.standard_normal((3, T_LEN, 1)).astype(np.float32),
            "h0": rng.standard_normal((3, HID)).astype(np.float32)}
    jmain, jstart, jloss, jout = _training_program(fluid)
    pmain, pstart, ploss, pout = _training_program(pt)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    jscope, params = _jax_params(jmain, jstart)
    pscope, pexe = pt.Scope(), pt.Executor(CPU)
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, params, CPU)
    jexe = fluid.Executor(fluid.CPUPlace())
    for _ in range(3):
        jl, jo = jexe.run(jmain, feed=feed, fetch_list=[jloss, jout],
                          scope=jscope)
        pl, po = pexe.run(pmain, feed=feed, fetch_list=[ploss, pout],
                          scope=pscope)
        assert po.shape == (3, T_LEN, 1)
        np.testing.assert_allclose(po, np.asarray(jo), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=TOL, atol=TOL)


MT = dict(vocab=60, word_dim=16, hidden_dim=16)


def test_contrib_mt_equals_the_book_model_bit_for_bit():
    tgt_len, batch = 5, 6
    cfeed, mfeed = mt.dense_target_feed(np.random.default_rng(2), batch,
                                        MT["vocab"], tgt_len, CPU,
                                        median=5.0, lo=2, hi=9)
    pt.framework.unique_name.reset()
    cmain, cstart, closs = mt.contrib_train(0.01, tgt_len=tgt_len, **MT)
    pt.framework.unique_name.reset()
    mmain, mstart, mloss = mt.mt_train(0.01, **MT)
    assert sorted(p.name for p in cmain.all_parameters()) == \
        sorted(p.name for p in mmain.all_parameters())
    scope = pt.Scope()
    pt.Executor(CPU).run(cstart, scope=scope)
    init = {p.name: np.array(scope.find_var(p.name).get_tensor())
            for p in cmain.all_parameters()}
    losses, scopes = {}, {}
    for name, main, start, loss, feed in (
            ("contrib", cmain, cstart, closs, cfeed),
            ("mt", mmain, mstart, mloss, mfeed)):
        scopes[name], exe = pt.Scope(), pt.Executor(CPU)
        exe.run(start, scope=scopes[name])
        load_params_from_numpy(scopes[name], init, CPU)
        losses[name] = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scopes[name])[0])
                        for _ in range(4)]
    assert losses["contrib"] == losses["mt"]
    assert len(set(losses["mt"])) == 4
    pt.framework.unique_name.reset()
    dprog, dids, dsc = mt.mt_decode(beam=3, max_len=6, **MT)
    pt.framework.unique_name.reset()
    cprog, cids, csc = mt.contrib_decode(beam=3, max_len=6, **MT)
    scope = scopes["mt"]
    for mine, theirs in mt.CONTRIB_NAMES.items():
        scope.var(mine).get_tensor().set(
            np.array(scope.find_var(theirs).get_tensor()), CPU)
    feed = mt.decode_feed(np.random.default_rng(3), 4, MT["vocab"], CPU,
                          median=5.0, lo=2, hi=9)
    exe = pt.Executor(CPU)
    want = exe.run(dprog, feed=feed, fetch_list=[dids, dsc], scope=scope)
    got = exe.run(cprog, feed=feed, fetch_list=[cids, csc], scope=scope)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_api_contract():
    pt.framework.unique_name.reset()
    with pt.program_guard(pt.Program(), pt.Program()):
        h0 = pt.layers.data("h0", [HID], dtype="float32")
        ids = pt.layers.data("init_ids", [1], dtype="int64", lod_level=2)
        sc = pt.layers.data("init_scores", [1], dtype="float32")
        dec = pt.contrib.decoder.BeamSearchDecoder(
            _cell(pt, h0), ids, sc, target_dict_dim=V, word_dim=E,
            max_len=2, beam_size=BEAM, end_id=EOS)
        with pytest.raises(RuntimeError):
            dec()
        dec.decode()
        with pytest.raises(ValueError):
            with dec.block():
                pass
        assert all(v is not None for v in dec())
        with pytest.raises(ValueError):
            dec.read_array(ids, is_ids=True, is_scores=True)
        with pytest.raises(ValueError):
            pt.contrib.decoder.InitState()
        cell = pt.contrib.decoder.StateCell({"x": None}, {"h": h0})
        with pytest.raises(RuntimeError):
            cell.compute_state({"x": h0})
        tdec = pt.contrib.decoder.TrainingDecoder(cell)
        with pytest.raises(RuntimeError):
            tdec.step_input(h0)
        with pytest.raises(RuntimeError):
            tdec()
