"""Sub-blocks, the control-flow ops and the recurrent block of the port
against the JAX package.

* The rank-table ops (lod_rank_table, lod_tensor_to_array,
  array_to_lod_tensor, reorder_lod_tensor_by_rank, shrink_rnn_memory,
  expand_to_rank_table_batch, max_sequence_len) and split_lod_tensor /
  merge_lod_tensor through both packages' lowerings on the same LoD (an
  empty sequence among them), and the array ops with a scalar index
  (the JAX lowering reads only a 0-d index; a program's [1] index runs
  in the port alone).
* Programs with sub-blocks, built by the same code in both packages:
  StaticRNN, DynamicRNN (a zero boot memory, static_input, a
  need_reorder boot memory), IfElse, While and Switch. Their
  ProgramDescs are the same bytes; forwards agree within FWD_RTOL /
  FWD_ATOL and 3 Adam steps (losses and every parameter) within
  TRAIN_RTOL, from the JAX package's initial parameters. The worst
  differences measured on the CPU are written beside each tolerance.
* clone / parse_from_string keep every block and its parent; the
  engine runs a DynamicRNN block captured (CPU replays) bit-equal to
  eager runs, the capture rule's meta run takes one step of the loop,
  and a While block stays eager with its reason in eager_reasons.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import LoDRankTable as JaxTable
from paddle_tpu.core.scope import LoDTensor as JaxLoD
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import TensorArray as JaxArray

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import engine as E
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.core.scope import LoDRankTable, TensorArray
from paddle_tpu_torch.io import load_params_from_numpy

from test_torch_ops import _Op
from torch_threads import one_torch_thread  # noqa: F401

# forward: worst measured 2.4e-7 absolute (float32 tanh/fc chains)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
# 3 Adam steps: worst measured 2.7e-7 relative on a loss, 3.8e-6
# relative on a parameter element
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6
STEPS = 3
CPU = torch.device("cpu")
LOD = [0, 2, 2, 7, 10]          # lengths 2, 0, 5, 3


# ---------------------------------------------------------------------------
# single ops through both lowerings
# ---------------------------------------------------------------------------

def _op(op_type, inputs, outputs, attrs=None):
    op = _Op(op_type, {}, [], attrs or {})
    op._inputs = {s: [f"{s.lower()}"] for s in inputs}
    op._outputs = {s: [f"{s.lower()}_out"] for s in outputs}
    return op


def _run_both(op_type, inputs, outputs, attrs=None, lods=None,
              table=None):
    """Run one op in each package. `inputs` maps a slot to a numpy
    array; `table` (offsets) adds a RankTable input of each package's
    own class. Returns (jax env, port env, jax lods, port lods)."""
    op = _op(op_type, list(inputs) + (["RankTable"] if table else []),
             outputs, attrs)
    jenv = {s.lower(): jnp.asarray(a) for s, a in inputs.items()}
    penv = {s.lower(): torch.from_numpy(np.array(a))
            for s, a in inputs.items()}
    if table is not None:
        jenv["ranktable"], penv["ranktable"] = JaxTable(table), \
            LoDRankTable(table)
    jl, pl = dict(lods or {}), dict(lods or {})
    JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, jl))
    PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU, None, pl))
    return jenv, penv, jl, pl


def _same(j, p):
    j = np.asarray(j)
    p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
    assert j.shape == p.shape, (j.shape, p.shape)
    np.testing.assert_array_equal(p, j.astype(p.dtype))


def test_lod_rank_table_matches_jax():
    x = np.zeros((10, 2), np.float32)
    jenv, penv, _, _ = _run_both("lod_rank_table", {"X": x}, ["Out"],
                                 {"level": 0}, lods={"x": [LOD]})
    j, p = jenv["out_out"], penv["out_out"]
    assert p.items == j.items == [(2, 5), (3, 3), (0, 2), (1, 0)]
    assert p.max_len == j.max_len and p.indices == j.indices
    # no LoD: each row is a sequence of length 1
    _, penv, _, _ = _run_both("lod_rank_table", {"X": x[:3]}, ["Out"])
    assert penv["out_out"].items == [(0, 1), (1, 1), (2, 1)]


@pytest.mark.parametrize("op_type,make,attrs", [
    ("lod_tensor_to_array", lambda r: r.standard_normal((10, 3)), {}),
    ("array_to_lod_tensor", lambda r: r.standard_normal((5, 4, 3)), {}),
    ("reorder_lod_tensor_by_rank", lambda r: r.standard_normal((4, 3)),
     {}),
    ("shrink_rnn_memory", lambda r: r.standard_normal((4, 3)), {}),
    ("expand_to_rank_table_batch", lambda r: r.standard_normal((1, 3)),
     {}),
], ids=lambda v: v if isinstance(v, str) else "")
def test_rank_table_op_matches_jax(op_type, make, attrs):
    x = make(np.random.default_rng(0)).astype(np.float32)
    jenv, penv, jl, pl = _run_both(op_type, {"X": x}, ["Out"], attrs,
                                   lods={"x": [LOD]}, table=LOD)
    _same(jenv["out_out"], penv["out_out"])
    assert pl.get("out_out") == jl.get("out_out")


def test_max_sequence_len_matches_jax():
    jenv, penv, _, _ = _run_both("max_sequence_len", {}, ["Out"],
                                 table=LOD)
    _same(jenv["out_out"], penv["out_out"])


@pytest.mark.parametrize("op_type", ["split_lod_tensor", "merge_lod_tensor"])
def test_split_merge_match_jax(op_type):
    r = np.random.default_rng(1)
    x = r.standard_normal((5, 3)).astype(np.float32)
    mask = (r.standard_normal((5, 1)) > 0)
    if op_type == "split_lod_tensor":
        ins, outs = {"X": x, "Mask": mask}, ["OutTrue", "OutFalse"]
    else:
        ins = {"InTrue": x, "InFalse": -x, "X": x, "Mask": mask}
        outs = ["Out"]
    jenv, penv, _, _ = _run_both(op_type, ins, outs)
    for s in outs:
        _same(jenv[f"{s.lower()}_out"], penv[f"{s.lower()}_out"])


def test_array_ops_match_jax():
    """write_to_array twice, read_from_array, lod_array_length and
    tensor_array_to_tensor (concat and stack) on one array."""
    r = np.random.default_rng(2)
    a, b = (r.standard_normal((2, 3)).astype(np.float32) for _ in "ab")
    jarr, parr = JaxArray(), TensorArray()
    for k, v in enumerate((a, b)):
        op = _op("write_to_array", ["X", "I"], ["Out"])
        op._outputs["Out"] = ["arr"]
        jenv = {"x": jnp.asarray(v), "i": jnp.asarray(k), "arr": jarr}
        penv = {"x": torch.from_numpy(v), "i": torch.tensor(k),
                "arr": parr}
        JAX_OPS.get("write_to_array").lowering(
            JaxContext(op, jenv, None, None, {}))
        PT_OPS.get("write_to_array").lowering(PtContext(op, penv, CPU))
        jarr, parr = jenv["arr"], penv["arr"]
    assert len(parr) == len(jarr) == 2

    def run(op_type, outs, attrs=None, **extra):
        op = _op(op_type, ["X"] + list(extra), outs, attrs)
        jenv = {"x": jarr, **{k.lower(): jnp.asarray(v)
                              for k, v in extra.items()}}
        penv = {"x": parr, **{k.lower(): torch.tensor(v)
                              for k, v in extra.items()}}
        JAX_OPS.get(op_type).lowering(JaxContext(op, jenv, None, None, {}))
        PT_OPS.get(op_type).lowering(PtContext(op, penv, CPU))
        for s in outs:
            _same(jenv[f"{s.lower()}_out"], penv[f"{s.lower()}_out"])

    run("read_from_array", ["Out"], I=1)
    run("lod_array_length", ["Out"])
    for stack in (False, True):
        run("tensor_array_to_tensor", ["Out", "OutIndex"],
            {"axis": 1, "use_stack": stack})


# ---------------------------------------------------------------------------
# programs with sub-blocks, built by the same code in both packages
# ---------------------------------------------------------------------------

def _static_rnn(fl, T=5, B=3, D=4, H=6):
    L = fl.layers
    x = L.data("x", [T, B, D], dtype="float32", append_batch_size=False)
    y = L.data("y", [T, B, H], dtype="float32", append_batch_size=False)
    rnn = L.StaticRNN()
    with rnn.step():
        word = rnn.step_input(x)
        prev = rnn.memory(shape=[-1, H], batch_ref=word, init_value=0.0)
        hidden = L.fc([word, prev], H, act="tanh")
        rnn.update_memory(prev, hidden)
        rnn.step_output(hidden)
    out = rnn()
    return L.mean(L.square(out - y)), out


def _dynamic_rnn(fl, D=3, H=4):
    L = fl.layers
    x = L.data("x", [D], dtype="float32", lod_level=1)
    y = L.data("y", [H], dtype="float32")
    drnn = L.DynamicRNN()
    with drnn.block():
        word = drnn.step_input(x)
        prev = drnn.memory(shape=[H], value=0.0)
        hidden = L.fc([word, prev], H, act="tanh")
        drnn.update_memory(prev, hidden)
        drnn.output(hidden)
    out = drnn()
    last = L.sequence_last_step(out)
    return L.mean(L.square(last - y)), out


def _dynamic_rnn_boot(fl, D=3, H=4):
    """A decoder-style DynamicRNN: its memory boots from a [B, H]
    tensor reordered by the rank table, and a static input joins every
    step."""
    L = fl.layers
    x = L.data("x", [D], dtype="float32", lod_level=1)
    s = L.data("s", [H], dtype="float32")
    boot = L.fc(s, H, act="tanh")
    drnn = L.DynamicRNN()
    with drnn.block():
        word = drnn.step_input(x)
        stat = drnn.static_input(s)
        prev = drnn.memory(init=boot, need_reorder=True)
        hidden = L.fc([word, prev, stat], H, act="tanh")
        drnn.update_memory(prev, hidden)
        drnn.output(hidden)
    out = drnn()
    return L.mean(L.sequence_pool(out, "sum")), out


def _ifelse(fl, D=3):
    L = fl.layers
    x = L.data("x", [D], dtype="float32")
    limit = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(L.reduce_sum(x, dim=1, keep_dim=True), limit)
    h = L.fc(x, D, act="tanh")
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(ie.input(h) * 2.0)
    with ie.false_block():
        ie.output(ie.input(h) - 1.0)
    out = ie()[0]
    return L.mean(L.square(out)), out


def _while(fl, D=3):
    L = fl.layers
    x = L.data("x", [D], dtype="float32")
    i = L.fill_constant([1], "float32", 0.0)
    n = L.fill_constant([1], "float32", 4.0)
    acc = L.assign(x)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        L.assign(L.elementwise_add(acc * 0.5, x), output=acc)
        L.increment(i, in_place=True)
        L.less_than(i, n, cond=cond)
    return None, acc * 1.0


def _switch(fl, D=3):
    L = fl.layers
    x = L.data("x", [D], dtype="float32")
    lr = L.fill_constant([1], "float32", 0.0)
    step = L.fill_constant([1], "float32", 3.0)
    with L.Switch() as sw:
        with sw.case(L.less_than(step, L.fill_constant([1], "float32",
                                                       5.0))):
            L.assign(L.fill_constant([1], "float32", 0.1), output=lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 1.0), output=lr)
    return None, L.elementwise_mul(x, lr)


def _feeds(name, lod_cls, rng):
    lens = [4, 2, 6, 3]
    off = list(np.concatenate([[0], np.cumsum(lens)]))
    if name == "static_rnn":
        return {"x": rng.standard_normal((5, 3, 4)).astype(np.float32),
                "y": rng.standard_normal((5, 3, 6)).astype(np.float32)}
    if name in ("dynamic_rnn", "dynamic_rnn_boot"):
        xv = rng.standard_normal((sum(lens), 3)).astype(np.float32)
        x = lod_cls(xv, off)
        if name == "dynamic_rnn":
            return {"x": x,
                    "y": rng.standard_normal((4, 4)).astype(np.float32)}
        return {"x": x,
                "s": rng.standard_normal((4, 4)).astype(np.float32)}
    return {"x": rng.standard_normal((6, 3)).astype(np.float32)}


BUILDERS = {"static_rnn": _static_rnn, "dynamic_rnn": _dynamic_rnn,
            "dynamic_rnn_boot": _dynamic_rnn_boot, "ifelse": _ifelse,
            "while": _while, "switch": _switch}


def _build(fl, name, train):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        loss, out = BUILDERS[name](fl)
        if train:
            fl.optimizer.AdamOptimizer(0.05).minimize(loss)
    return main, startup, loss, out


def _jax_lod(a, off):
    return JaxLoD(a, [off])


def _pt_lod(a, off):
    return pt.LoDTensor(torch.from_numpy(a), [off])


def _both_programs(name, train):
    """Run the program `STEPS` times (train) or once in each package
    from the JAX package's initial parameters; returns ((jax fetches,
    jax scope), (port fetches, port scope), jax main, port main)."""
    jmain, jstart, jloss, jout = _build(fluid, name, train)
    pmain, pstart, ploss, pout = _build(pt, name, train)
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    params = {p.name: np.asarray(jscope.find_var(p.name).get_tensor())
              for p in jmain.all_parameters()}
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, params, pt.CPUPlace())
    jfeed = _feeds(name, _jax_lod, np.random.default_rng(7))
    pfeed = _feeds(name, _pt_lod, np.random.default_rng(7))
    jfetch = [v for v in (jloss, jout) if v is not None]
    pfetch = [v for v in (ploss, pout) if v is not None]
    jres, pres = [], []
    for _ in range(STEPS if train else 1):
        jres.append(jexe.run(jmain, feed=jfeed, fetch_list=jfetch,
                             scope=jscope))
        pres.append(pexe.run(pmain, feed=pfeed, fetch_list=pfetch,
                             scope=pscope))
    return (jres, jscope), (pres, pscope), jmain, pmain, params


def _arr(v):
    return np.asarray(v.array if hasattr(v, "array") else v)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_program_forward_matches_jax(name):
    (jres, _), (pres, _), jmain, pmain, _ = _both_programs(name, False)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    assert len(pmain.blocks) == len(jmain.blocks)
    for j, p in zip(jres[0], pres[0]):
        np.testing.assert_allclose(_arr(p), _arr(j), rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
    if name in ("dynamic_rnn", "dynamic_rnn_boot"):
        assert pres[0][-1].lod() == [[0, 4, 6, 12, 15]]


@pytest.mark.parametrize("name", ["static_rnn", "dynamic_rnn",
                                  "dynamic_rnn_boot", "ifelse"])
def test_program_trains_like_jax(name):
    """3 Adam steps: the losses and every parameter (gradients through
    the recurrent loop's generic gradient) against the JAX package."""
    (jres, jscope), (pres, pscope), jmain, pmain, params = \
        _both_programs(name, True)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    for j, p in zip(jres, pres):
        np.testing.assert_allclose(_arr(p[0]), _arr(j[0]),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    moved = 0
    for n, start in params.items():
        j = np.asarray(jscope.find_var(n).get_tensor())
        p = np.asarray(pscope.find_var(n).get_tensor())
        np.testing.assert_allclose(p, j, rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=n)
        moved += not np.array_equal(p, start)
    assert moved == len(params)


# ---------------------------------------------------------------------------
# blocks in the IR and the engine
# ---------------------------------------------------------------------------

def test_blocks_clone_and_parse_keep_parents():
    main, _, _, _ = _build(pt, "dynamic_rnn", True)
    assert [b.parent_idx for b in main.blocks] == [-1, 0]
    sub = main.block(1)
    assert sub.var("fc_0.w_0") is main.global_block().vars["fc_0.w_0"]
    for k, p in enumerate((
            main.clone(), main.clone(for_test=True),
            pt.Program.parse_from_string(main.serialize_to_string()))):
        assert [b.parent_idx for b in p.blocks] == [-1, 0]
        assert [o.type for o in p.block(1).ops] == \
            [o.type for o in sub.ops]
        rec = [o for o in p.global_block().ops if o.type == "recurrent"][0]
        assert rec.attr("sub_block").idx == 1
        # a test clone sets is_test: the other two are the same bytes
        assert (p.serialize_to_string() == main.serialize_to_string()) \
            == (k != 1)
    assert main.current_block_idx == 0


def test_recurrent_replays_bit_equal_to_eager():
    """The DynamicRNN training block: the capture rule admits it (its
    meta run takes one step of the loop), and 3 CPU replays of the
    captured plan equal 3 eager runs bit for bit."""
    params = None
    runs = {}
    for cached in (True, False):
        main, start, loss, _ = _build(pt, "dynamic_rnn", True)
        scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
        exe.run(start, scope=scope)
        if params is None:
            params = {p.name: np.asarray(scope.find_var(p.name)
                                         .get_tensor())
                      for p in main.all_parameters()}
        load_params_from_numpy(scope, params, pt.CPUPlace())
        feed = _feeds("dynamic_rnn", _pt_lod, np.random.default_rng(3))
        runs[cached] = [np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope,
            use_program_cache=cached)[0]) for _ in range(4)]
        if cached:
            c = exe._engine.counters
            assert c["captures"] == 1 and c["replays"] == 3, c
            assert not exe._engine.eager_reasons
    for a, b in zip(runs[True], runs[False]):
        assert a.tobytes() == b.tobytes()


def test_meta_run_takes_one_step(monkeypatch):
    main, start, loss, _ = _build(pt, "dynamic_rnn", True)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(start, scope=scope)
    feed = _feeds("dynamic_rnn", _pt_lod, np.random.default_rng(3))
    seen = []
    orig = E.SubBlocks.__call__

    def counting(self, idx, env, device, run):
        seen.append(device.type)
        return orig(self, idx, env, device, run)

    monkeypatch.setattr(E.SubBlocks, "__call__", counting)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert seen.count("cpu") == 6   # the longest sequence is 6
    seen.clear()
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert seen.count("meta") == 1, seen


def test_while_block_stays_eager():
    main, start, _, out = _build(pt, "while", False)
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((2, 3), np.float32)}
    for _ in range(3):
        res = exe.run(main, feed=feed, fetch_list=[out])[0]
    np.testing.assert_allclose(res, 1.9375 * np.ones((2, 3)), rtol=1e-6)
    assert list(exe._engine.eager_reasons.values()) == ["while"]
    c = exe._engine.counters
    assert c["captures"] == 0 and c["eager_runs"] == 3, c


def _conditional(fl, flag):
    """A conditional_block built by hand, as a reference program holds
    one: its sub-block writes 3x into `out` when 0 < (1 or -1)."""
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = L.data("x", [3], dtype="float32")
        out = L.assign(x)
        cond = L.less_than(L.fill_constant([1], "float32", 0.0),
                           L.fill_constant([1], "float32",
                                           1.0 if flag else -1.0))
        sub = main._create_block()
        L.assign(x * 3.0, output=out)
        main._rollback()
        main.global_block().append_op(
            "conditional_block", inputs={"Cond": [cond], "Input": [x]},
            outputs={"Out": [out], "Scope": []},
            attrs={"sub_block": sub, "is_scalar_condition": True})
        shown = L.Print(out, message="cond out")
    return main, shown


@pytest.mark.parametrize("flag", [True, False])
def test_conditional_block_and_print_match_jax(flag, capsys):
    """The body runs only when the condition holds; Print passes its
    input on and prints it on the host each run; the block stays eager
    (its condition is read on the host)."""
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jmain, jshown = _conditional(fluid, flag)
    pmain, pshown = _conditional(pt, flag)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    want = np.asarray(fluid.Executor(fluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jshown], scope=JaxScope())[0])
    capsys.readouterr()
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    for _ in range(2):
        got = exe.run(pmain, feed=feed, fetch_list=[pshown],
                      scope=scope)[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, feed["x"] * (3.0 if flag else 1.0))
    assert capsys.readouterr().out.count("cond out") == 2
    assert list(exe._engine.eager_reasons.values()) == ["conditional_block"]


def test_delete_var_and_assert():
    op = _op("delete_var", ["X"], [])
    env = {"x": torch.ones(2), "y": torch.zeros(1)}
    PT_OPS.get("delete_var").lowering(PtContext(op, env, CPU))
    assert list(env) == ["y"]
    PT_OPS.get("assert").lowering(PtContext(_op("assert", ["Cond"], []),
                                            {}, CPU))


# ---------------------------------------------------------------------------
# py_func (tests/test_misc_ops.py's three cases, through both packages)
# ---------------------------------------------------------------------------

def _py_func_program(fl, case):
    """(main, startup, feed, fetch names) of one py_func case."""
    L = fl.layers
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        if case == "forward":
            x = L.data("x", [3], dtype="float32")
            out = main.global_block().create_var(
                name="pyout", shape=[-1, 3], dtype="float32")
            L.py_func(lambda a: a * 2, x, out)
            feed, fetch = {"x": np.arange(6, dtype=np.float32)
                           .reshape(2, 3)}, ["pyout"]
        elif case == "backward":
            x = L.data("x", [3], dtype="float32")
            x.stop_gradient = False
            out = main.global_block().create_var(
                name="pf_out", shape=[-1, 3], dtype="float32")
            L.py_func(lambda a: a * 3, x, out,
                      backward_func=lambda a, o, d: d * 3)
            g, = fl.gradients(L.reduce_sum(out), x)
            feed, fetch = {"x": np.ones((2, 3), np.float32)}, \
                ["pf_out", g.name]
        else:
            a = L.data("a", [3], dtype="float32")
            b = L.data("b", [5], dtype="float32")
            a.stop_gradient = b.stop_gradient = False
            h = L.fc(b, 5)   # downstream of b, so b's gradient is asked
            out = main.global_block().create_var(
                name="pf2_out", shape=[-1, 3], dtype="float32")
            L.py_func(lambda p, q: p, [a, h], out)
            loss = L.elementwise_add(L.reduce_sum(out), L.reduce_sum(h))
            ga, gb = fl.gradients(loss, [a, b])
            feed = {"a": np.ones((2, 3), np.float32),
                    "b": np.ones((2, 5), np.float32)}
            fetch = [ga.name, gb.name]
    return main, startup, feed, fetch


@pytest.mark.parametrize("case", ["forward", "backward", "zero_grads"])
def test_py_func_matches_jax(case):
    """py_func's forward, its backward_func through py_func_grad, and,
    with no backward_func, zero gradients of each input's own shape: the
    same ProgramDesc bytes and results as the JAX package; the block
    stays eager (reason py_func) over 3 runs."""
    jmain, jstart, feed, fetch = _py_func_program(fluid, case)
    pmain, pstart, _, _ = _py_func_program(pt, case)
    assert pmain.serialize_to_string() == jmain.serialize_to_string()
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
    pexe.run(pstart, scope=pscope)
    load_params_from_numpy(pscope, {
        p.name: np.asarray(jscope.find_var(p.name).get_tensor())
        for p in jmain.all_parameters()}, pt.CPUPlace())
    runs = pexe._engine.counters["eager_runs"]
    for _ in range(3):
        got = pexe.run(pmain, feed=feed, fetch_list=fetch, scope=pscope)
        for w, g in zip(want, got):
            assert np.asarray(g).shape == np.asarray(w).shape
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=FWD_RTOL, atol=FWD_ATOL)
    if case == "zero_grads":
        np.testing.assert_array_equal(np.asarray(got[0]),
                                      np.zeros((2, 3), np.float32))
    assert list(pexe._engine.eager_reasons.values()) == ["py_func"]
    c = pexe._engine.counters
    assert c["captures"] == 0 and c["eager_runs"] == runs + 3, c
