"""Nested scopes, the package's and framework's names, and the
constructors' argument order in the port, against the JAX package.

* Nested scopes: `Scope(parent)`, `new_scope()`, `drop_kids()` and a
  `find_var` that walks up to the parents behave as the JAX package's
  Scope. A training program run in a child scope reads and updates the
  parameters its parent holds (the reference keeps persistables in the
  outer scope), and its losses equal the JAX package's run in one scope
  (the JAX Executor cannot run in a child scope: it makes an empty local
  variable for each parameter). A plan made in a child scope is made
  again after the parent erases a name, after `drop_kids()` and after a
  name made in the child hides the parent's.
* The package exports the reference's names (`fluid.append_backward`,
  `Variable`, `name_scope`, the places, the flags, `LoDTensorArray`,
  `EnforceNotMet`), and `framework.grad_var_name` and `name_scope`
  exist; append_backward builds the JAX package's ProgramDesc bytes.
* `Variable(block, name, shape, dtype, lod_level, ...)` takes lod_level
  fifth and `LoDTensor(array=...)` its array by that name, as in the JAX
  package.

Tolerance: losses and parameters within 1e-6 relative (float32 SGD from
the same parameters; the sums' order differs between the frameworks).
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.scope import Scope as PtScope
from paddle_tpu_torch.io import load_params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6


@pytest.mark.parametrize("Scope", [JaxScope, PtScope],
                         ids=["jax", "port"])
def test_scope_tree(Scope):
    root = Scope()
    root.var("a")
    kid = root.new_scope()
    assert isinstance(kid, Scope) and Scope(root).find_var("a") is \
        root.find_var("a")
    grandkid = kid.new_scope()
    assert grandkid.find_var("a") is root.find_var("a")
    assert kid.find_var("nope") is None
    b = kid.var("b")
    assert root.find_var("b") is None and grandkid.find_var("b") is b
    hidden = kid.var("a")
    assert hidden is not root.find_var("a")
    assert grandkid.find_var("a") is hidden
    assert kid.local_var_names() == ["b", "a"]
    root.drop_kids()
    assert root._kids == []
    with (fluid if Scope is JaxScope else pt).scope_guard(root.new_scope()):
        g = (fluid if Scope is JaxScope else pt).global_scope()
        assert g is not root and g.find_var("a") is root.find_var("a")


def test_generation_follows_the_parents():
    root = PtScope()
    root.var("w")
    kid = root.new_scope()
    g = kid.generation
    kid.var("x")                        # a new name hides nothing
    assert kid.generation == g
    root.erase(["nothing"])
    assert kid.generation > g
    g = kid.generation
    kid.var("w")                        # hides the parent's w
    assert kid.generation > g
    g = kid.generation
    root.drop_kids()
    assert kid.generation > g


def _sgd(fl, train=True):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", [4], dtype="float32")
        y = fl.layers.data("y", [1], dtype="float32")
        pred = fl.layers.fc(x, 1, param_attr=fl.ParamAttr(name="w"),
                            bias_attr=fl.ParamAttr(name="b"))
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        if train:
            fl.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_a_plan_in_a_child_scope():
    rng = np.random.default_rng(0)
    feeds = [{"x": rng.standard_normal((6, 4)).astype(np.float32),
              "y": rng.standard_normal((6, 1)).astype(np.float32)}
             for _ in range(5)]
    jmain, jstart, jloss = _sgd(fluid)
    jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {n: np.asarray(jscope.find_var(n).get_tensor()).copy()
            for n in ("w", "b")}
    jl = [float(jexe.run(jmain, feed=f, fetch_list=[jloss],
                         scope=jscope)[0]) for f in feeds]

    main, startup, loss = _sgd(pt)
    root, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=root)
    load_params_from_numpy(root, init, pt.CPUPlace())
    w = root.find_var("w")
    kid = root.new_scope()
    pl = []
    for f in feeds[:3]:      # a plan, then its capture, then a replay
        pl.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=kid)[0]))
    c = dict(exe._engine.counters)
    # startup's plan and main's; main captured once
    assert (c["traces"], c["captures"]) == (2, 1), c
    assert kid.find_var("w") is w and "w" not in kid.local_var_names()
    root.drop_kids()
    with pt.scope_guard(root.new_scope()):
        pl.append(float(exe.run(main, feed=feeds[3], fetch_list=[loss])[0]))
    assert exe._engine.counters["traces"] == 3     # a new plan
    # the dropped child's plan is made again, not reused
    pl.append(float(exe.run(main, feed=feeds[4], fetch_list=[loss],
                            scope=kid)[0]))
    assert exe._engine.counters["traces"] == 4
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    for n in ("w", "b"):
        np.testing.assert_allclose(
            np.asarray(root.find_var(n).get_tensor()),
            np.asarray(jscope.find_var(n).get_tensor()), rtol=RTOL,
            atol=1e-7)
    # the parent erases a parameter: the child's plan is not reused
    # with the erased Variable; the run names what is missing
    root.erase(["w"])
    with pytest.raises(RuntimeError, match="w"):
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=kid)


def test_hiding_a_parent_variable_makes_a_new_plan():
    test, startup, loss = _sgd(pt, train=False)
    root, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=root)
    feed = {"x": np.ones((2, 4), np.float32),
            "y": np.zeros((2, 1), np.float32)}
    kid = root.new_scope()
    for _ in range(2):
        exe.run(test, feed=feed, fetch_list=[loss], scope=kid)
    traces = exe._engine.counters["traces"]
    kid.var("b").get_tensor().set(np.full([1], 5.0, np.float32),
                                  pt.CPUPlace())
    out = exe.run(test, feed=feed, fetch_list=[loss], scope=kid)
    assert exe._engine.counters["traces"] == traces + 1
    w = np.asarray(root.find_var("w").get_tensor())
    want = np.mean((np.ones((2, 4), np.float32) @ w + 5.0) ** 2)
    np.testing.assert_allclose(float(out[0]), want, rtol=RTOL)


NAMES = ["append_backward", "Variable", "Block", "Operator", "Parameter",
         "name_scope", "get_flags", "set_flags", "cpu_places",
         "cuda_places", "cuda_pinned_places", "CUDAPinnedPlace",
         "is_compiled_with_cuda", "LoDTensorArray", "EnforceNotMet"]


@pytest.mark.parametrize("name", NAMES)
def test_the_package_exports_the_reference_name(name):
    assert hasattr(fluid, name)
    assert hasattr(pt, name), name


def test_append_backward_and_grad_var_name():
    progs = []
    for fl in (fluid, pt):
        fl.framework.unique_name.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            with fl.name_scope("net"), fl.framework.name_scope("inner"):
                x = fl.layers.data("x", [3], dtype="float32")
                loss = fl.layers.mean(fl.layers.fc(x, 2))
            pairs = fl.append_backward(loss)
        assert [(p.name, g.name) for p, g in pairs] == \
            [(p.name, fl.framework.grad_var_name(p.name))
             for p in main.all_parameters()]
        progs.append(main.serialize_to_string())
    assert pt.framework.grad_var_name("w") == \
        fluid.framework.grad_var_name("w") == "w@GRAD"
    assert progs[0] == progs[1]
    assert pt.get_flags(["FLAGS_use_custom_kernels"]) == \
        {"FLAGS_use_custom_kernels": True}
    assert [p.device_id for p in pt.cpu_places(2)] == [0, 1]
    assert pt.cuda_places([1])[0] == pt.CUDAPlace(1)
    assert isinstance(pt.cuda_pinned_places(1)[0], pt.CUDAPinnedPlace)
    assert pt.is_compiled_with_cuda() is False    # no card here
    assert issubclass(pt.EnforceNotMet, RuntimeError)
    arr = pt.LoDTensorArray()
    arr.append(3)
    assert arr == [3]


def test_variable_takes_lod_level_fifth():
    for fl in (fluid, pt):
        block = fl.Program().global_block()
        v = fl.Variable(block, "v", [2, 3], "float32", 1)
        assert (v.lod_level, v.persistable, v.stop_gradient) == \
            (1, False, False)
        v = fl.framework.Variable(block, "u", [2], "int64", 2, True, True)
        assert (v.lod_level, v.persistable, v.stop_gradient) == \
            (2, True, True)
    # the port serializes it as the JAX package does, dim_sharding too
    descs = []
    for fl in (fluid, pt):
        prog = fl.Program()
        fl.framework.Variable(prog.global_block(), "s", [4, 8], "float32",
                              0, True, dim_sharding=["dp", ""])
        prog.global_block().vars["s"] = fl.framework.Variable(
            prog.global_block(), "s", [4, 8], "float32", 0, True,
            dim_sharding=["dp", ""])
        descs.append(prog.serialize_to_string())
    assert descs[0] == descs[1]
    back = pt.Program.parse_from_string(descs[0])
    assert back.global_block().vars["s"].dim_sharding == ["dp", ""]


def test_lod_tensor_takes_array():
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    for fl in (fluid, pt):
        t = fl.LoDTensor(array=x, lod=[[0, 1, 3]])
        np.testing.assert_array_equal(np.asarray(t), x)
        assert t.lod() == [[0, 1, 3]]
        assert t.recursive_sequence_lengths() == [[1, 2]]
    assert pt.LoDTensor(x).shape() == (3, 2)
