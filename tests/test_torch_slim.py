"""contrib.slim's pruning, distillation, NAS and Compressor in the port,
against the JAX package: one case for each test of
tests/test_slim_compress.py and tests/test_slim_pipeline.py, each run
through the port with the JAX test's assertions, and held to the JAX
package where the two compute the same thing:

* the pruners' masks and pruned weights from the same weights: equal
  (both rank in numpy);
* the merged teacher + student program of `merge` and the distillation
  losses: the JAX package's op for op and var for var;
* the SAController and the controller server: the same seeded search
  gives the same tokens and rewards (pure Python in both);
* the config-driven pipeline (distillation, then pruning, then QAT) and
  sensitivity pruning: the same strategy schedule, program rewrites and
  files; accuracies above the JAX test's bars.

Every socket wait has a timeout: a server's accept wakes every
ControllerServer.poll seconds, reads give up after its timeout, and
close() joins the thread.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib.slim import distillation as jdist
from paddle_tpu.contrib.slim import nas as jnas
from paddle_tpu.contrib.slim import prune as jprune
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib.slim import distillation as pdist
from paddle_tpu_torch.contrib.slim import nas as pnas
from paddle_tpu_torch.contrib.slim import prune as pprune
from paddle_tpu_torch.contrib.slim.core import Compressor
from paddle_tpu_torch.io import load_params_from_numpy

from test_torch_quantization import _same_program


def _blobs(n, seed, sigma=0.5):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 4, size=(n, 1))
    centers = np.array([[2, 2], [-2, 2], [2, -2], [-2, -2]], np.float32)
    x = centers[y[:, 0]] + rng.normal(0, sigma, (n, 2))
    return x.astype(np.float32), y.astype(np.int64)


def _classifier(fl, width=32, prefix="", dim=2, classes=4, names=("x", "y")):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(names[0], [dim], dtype="float32")
        y = fl.layers.data(names[1], [1], dtype="int64")
        h = fl.layers.fc(x, width, act="relu",
                         param_attr=fl.ParamAttr(name=prefix + "w0"))
        logits = fl.layers.fc(h, classes,
                              param_attr=fl.ParamAttr(name=prefix + "w1"))
        sm = fl.layers.softmax(logits)
        loss = fl.layers.mean(fl.layers.cross_entropy(sm, y))
        acc = fl.layers.accuracy(sm, y)
    return main, startup, loss, acc, logits, h


def _acc(exe, prog, acc, feed, scope):
    return float(np.asarray(exe.run(prog, feed=feed, fetch_list=[acc.name],
                                    scope=scope)[0]))


# ---------------------------------------------------------------------------
# test_slim_compress.py
# ---------------------------------------------------------------------------

def test_prune_finetune_keeps_accuracy_and_sparsity():
    pt.framework.unique_name.reset()
    main, startup, loss, acc, _, _ = _classifier(pt)
    with pt.program_guard(main, startup):
        pt.optimizer.AdamOptimizer(0.02).minimize(loss)
    xs, ys = _blobs(256, 0)
    feed = {"x": xs, "y": ys}
    sc, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=sc)
    for _ in range(40):
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=sc)
    assert _acc(exe, main, acc, feed, sc) > 0.9
    w = np.asarray(sc.find_var("w0").get_tensor())
    with pt.scope_guard(sc):
        masks = pprune.MagnitudePruner().prune(main, ["w0"], [0.5])
    # the JAX pruner's mask on the same weights
    jsc = JaxScope()
    jsc.var("w0").get_tensor().set(w)
    jmasks = jprune.MagnitudePruner(scope=jsc).prune(None, ["w0"], [0.5])
    np.testing.assert_array_equal(masks["w0"], jmasks["w0"])
    np.testing.assert_array_equal(np.asarray(sc.find_var("w0").get_tensor()),
                                  np.asarray(jsc.find_var("w0").get_tensor()))
    assert (np.asarray(sc.find_var("w0").get_tensor()) == 0).mean() >= 0.45
    for _ in range(30):
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=sc)
        pprune.apply_prune_masks(sc, masks)
    assert (np.asarray(sc.find_var("w0").get_tensor()) == 0).mean() >= 0.45
    assert _acc(exe, main, acc, feed, sc) > 0.9


def test_structured_pruner_removes_columns():
    pt.framework.unique_name.reset()
    main, startup, _, _, _, _ = _classifier(pt, width=16)
    sc = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=sc)
    w = np.asarray(sc.find_var("w0").get_tensor())
    masks = pprune.StructuredPruner(scope=sc).prune(main, ["w0"], [0.25])
    got = np.asarray(sc.find_var("w0").get_tensor())
    assert (got == 0).all(axis=0).sum() == 4
    jsc = JaxScope()
    jsc.var("w0").get_tensor().set(w)
    jmasks = jprune.StructuredPruner(scope=jsc).prune(None, ["w0"], [0.25])
    np.testing.assert_array_equal(masks["w0"], jmasks["w0"])
    np.testing.assert_array_equal(got, np.asarray(
        jsc.find_var("w0").get_tensor()))


def test_distillation_merge_and_losses():
    """The merged program and the two losses equal the JAX package's;
    then the port trains the student through them as the JAX test
    does."""
    xs, ys = _blobs(256, 1)
    feed = {"x": xs, "y": ys}
    built = {}
    for fl, dist in ((fluid, jdist), (pt, pdist)):
        fl.framework.unique_name.reset()
        t_main, t_start, t_loss, _, t_logits, _ = _classifier(fl, 64, "t_")
        t_infer = t_main.clone(for_test=True)
        with fl.program_guard(t_main, t_start):
            fl.optimizer.AdamOptimizer(0.02).minimize(t_loss)
        sc = JaxScope() if fl is fluid else pt.Scope()
        if fl is pt:
            exe = pt.Executor(pt.CPUPlace())
            exe.run(t_start, scope=sc)
            for _ in range(60):
                exe.run(t_main, feed=feed, fetch_list=[t_loss.name],
                        scope=sc)
        fl.framework.unique_name.reset()
        s_main, s_start, s_loss, s_acc, s_logits, _ = _classifier(fl, 8,
                                                                  "s_")
        with fl.scope_guard(sc):
            merged = dist.merge(t_infer, s_main, {"x": "x", "y": "y"},
                                scope=sc)
        dl = dist.soft_label_loss("teacher_" + t_logits.name,
                                  s_logits.name, merged)
        l2 = dist.l2_loss("teacher_" + t_logits.name, s_logits.name,
                          merged)
        built[fl] = (merged, s_start, s_loss, s_acc, dl, l2, sc)
    _same_program(built[pt][0], built[fluid][0])
    merged, s_start, s_loss, s_acc, dl, l2, sc = built[pt]
    np.testing.assert_array_equal(
        np.asarray(sc.find_var("teacher_t_w0").get_tensor()),
        np.asarray(sc.find_var("t_w0").get_tensor()))
    with pt.program_guard(merged, s_start):
        total = pt.layers.elementwise_add(
            pt.layers.elementwise_add(s_loss, dl), l2)
        pt.optimizer.AdamOptimizer(0.02).minimize(total)
    exe.run(s_start, scope=sc)
    t0 = np.asarray(sc.find_var("teacher_t_w0").get_tensor()).copy()
    losses = [float(np.asarray(exe.run(merged, feed=feed,
                                       fetch_list=[total.name],
                                       scope=sc)[0])) for _ in range(60)]
    assert losses[-1] < losses[0]
    assert _acc(exe, merged, s_acc, feed, sc) > 0.85
    # the teacher's weights were not trained by the student's optimizer
    np.testing.assert_array_equal(
        np.asarray(sc.find_var("teacher_t_w0").get_tensor()), t0)


def test_sa_controller_minimizes_toy_objective():
    def reward(tokens):
        return -float((sum(tokens) - 10) ** 2)

    found = []
    for mod in (jnas, pnas):
        ctrl = mod.SAController(range_table=[8] * 4, max_iter_number=400,
                                seed=3)
        found.append(ctrl.search(reward, init_tokens=[0, 0, 0, 0]))
    (jbest, jr), (best, r) = found
    assert sum(best) == 10 and r == 0.0
    assert (best, r) == (jbest, jr)


# ---------------------------------------------------------------------------
# test_slim_pipeline.py
# ---------------------------------------------------------------------------

_PROTOS = np.random.RandomState(42).normal(0, 1, (10, 64)).astype(
    np.float32)


def _mnist_data(n, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=(n, 1))
    x = _PROTOS[y[:, 0]] + rng.normal(0, 0.35, (n, 64))
    return x.astype(np.float32), y.astype(np.int64)


def _mnist_net(width, prefix=""):
    main, startup, loss, acc, logits, _ = _classifier(
        pt, width, prefix, dim=64, classes=10, names=("img", "label"))
    return main, startup, loss, acc, logits


def _reader(xs, ys, bs=64):
    def r():
        for i in range(0, len(xs), bs):
            yield {"img": xs[i:i + bs], "label": ys[i:i + bs]}
    return r


CONFIG = """
version: 1.0
pruners:
    pruner_1:
        class: 'StructuredPruner'
strategies:
    distill_strategy:
        class: 'DistillationStrategy'
        distillers: ['soft_distiller']
        start_epoch: 0
        end_epoch: 2
    prune_strategy:
        class: 'UniformPruneStrategy'
        pruner: 'pruner_1'
        start_epoch: 2
        target_ratio: 0.25
        pruned_params: 'w0'
        metric_name: 'acc'
    quant_strategy:
        class: 'QuantizationStrategy'
        start_epoch: 3
        weight_bits: 8
        activation_bits: 8
        int8_model_save_path: '{int8_dir}'
distillers:
    soft_distiller:
        class: 'SoftLabelDistiller'
        teacher_feature_map: '{teacher_logits}'
        student_feature_map: '{student_logits}'
        distillation_loss_weight: 1.0
compressor:
    epoch: 4
    checkpoint_path: '{ckpt_dir}'
    strategies:
        - distill_strategy
        - prune_strategy
        - quant_strategy
"""


def test_config_driven_compress_pipeline(tmp_path):
    pytest.importorskip("yaml")
    xs, ys = _mnist_data(512, 0)
    exs, eys = _mnist_data(256, 1)
    pt.framework.unique_name.reset()
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    t_main, t_start, t_loss, t_acc, t_logits = _mnist_net(64, "t_")
    t_opt = t_main.clone()
    with pt.program_guard(t_opt, t_start):
        pt.optimizer.AdamOptimizer(0.05).minimize(
            t_opt.global_block().var(t_loss.name))
    exe.run(t_start, scope=scope)
    for _ in range(30):
        exe.run(t_opt, feed={"img": xs, "label": ys},
                fetch_list=[t_loss.name], scope=scope)
    s_main, s_start, s_loss, s_acc, s_logits = _mnist_net(24)
    exe.run(s_start, scope=scope)
    cfg = CONFIG.format(teacher_logits=t_logits.name,
                        student_logits=s_logits.name,
                        int8_dir=str(tmp_path / "int8"),
                        ckpt_dir=str(tmp_path / "ckpt"))
    cfg_path = tmp_path / "compress.yaml"
    cfg_path.write_text(cfg)
    comp = Compressor(
        pt.CPUPlace(), scope, s_main, train_reader=_reader(xs, ys),
        train_feed_list=["img", "label"],
        train_fetch_list=[s_loss.name, s_acc.name],
        eval_program=s_main.clone(for_test=True),
        eval_reader=_reader(exs, eys, bs=256),
        eval_feed_list=["img", "label"], eval_fetch_list=[s_acc.name],
        teacher_programs=[t_main.clone(for_test=True)],
        train_optimizer=pt.optimizer.AdamOptimizer(0.03),
        distiller_optimizer=pt.optimizer.AdamOptimizer(0.03),
        log_period=1000)
    comp.config(str(cfg_path))
    assert comp.epoch == 4 and len(comp.strategies) == 3
    assert [type(s).__name__ for s in comp.strategies] == [
        "DistillationStrategy", "UniformPruneStrategy",
        "QuantizationStrategy"]
    ctx = comp.run()
    accs = ctx.eval_results[s_acc.name]
    assert len(accs) == 4 and accs[-1] > 0.7, accs
    w0 = np.asarray(scope.find_var("w0").get_tensor())
    assert 0.2 <= (np.abs(w0).sum(0) == 0).mean() <= 0.3
    q_ops = [op.type for op in ctx.eval_graph[0].global_block().ops]
    assert any(t.startswith("fake_") for t in q_ops), q_ops
    assert (tmp_path / "int8" / "__model__").exists()
    assert (tmp_path / "ckpt" / "compress.state").exists()
    # the int8 export loads in the JAX package too
    jexe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(JaxScope()):
        prog, feeds, fetches = fluid.io.load_inference_model(
            str(tmp_path / "int8"), jexe)
    assert feeds == ["img", "label"]
    assert [o.type for o in prog.global_block().ops].count(
        "fake_quantize_dequantize_moving_average_abs_max") == 2


def test_sensitivity_pruning_orders_ratios():
    xs, ys = _mnist_data(256, 2)
    pt.framework.unique_name.reset()
    scope = pt.Scope()
    main, startup, loss, acc, _ = _mnist_net(32)
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    comp = Compressor(
        pt.CPUPlace(), scope, main, train_reader=_reader(xs, ys),
        train_feed_list=["img", "label"],
        train_fetch_list=[loss.name, acc.name],
        eval_program=main.clone(for_test=True),
        eval_reader=_reader(xs, ys, bs=256),
        eval_feed_list=["img", "label"], eval_fetch_list=[acc.name],
        train_optimizer=pt.optimizer.AdamOptimizer(0.03),
        epoch=2, log_period=1000)
    strat = pprune.SensitivePruneStrategy(
        pruner=pprune.StructuredPruner(scope=scope), start_epoch=1,
        target_ratio=0.2, metric_name=acc.name, pruned_params="w[01]",
        delta_rate=0.3)
    comp.strategies = [strat]
    comp.run()
    assert set(strat.sensitivities) == {"w0", "w1"}
    for losses in strat.sensitivities.values():
        assert sorted(losses) == [0.3, 0.6, 0.9]
        assert all(np.isfinite(v) for v in losses.values())
    assert strat.pruned_list == ["w0", "w1"]


def test_nas_controller_server_agent_roundtrip():
    """The same seeded search through the port's server and agent as
    through the JAX package's: the same best tokens and reward."""
    def roundtrip(mod):
        ctrl = mod.SAController(range_table=[8, 8, 8], max_iter_number=50,
                                seed=3)
        server = mod.ControllerServer(controller=ctrl, key="k")
        server.start()
        try:
            agent = mod.SearchAgent("127.0.0.1", server.port(), key="k")
            for _ in range(40):
                tokens = agent.next_tokens()
                agent.update(tokens, -sum((t - 6) ** 2 for t in tokens))
        finally:
            server.close()
        assert not server._thread.is_alive()
        return ctrl.best_tokens, ctrl.max_reward
    best, reward = roundtrip(pnas)
    assert reward > -12, (best, reward)
    assert (best, reward) == roundtrip(jnas)


def test_light_nas_strategy_through_compressor():
    class ToySpace(pnas.SearchSpaceBase):
        def range_table(self):
            return [8, 8]

        def init_tokens(self):
            return [0, 0]

        def eval_tokens(self, tokens, context):
            return -sum((t - 5) ** 2 for t in tokens)

    pt.framework.unique_name.reset()
    scope = pt.Scope()
    main, startup, loss, acc, _ = _mnist_net(8)
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope)
    comp = Compressor(pt.CPUPlace(), scope, main,
                      train_feed_list=["img", "label"],
                      train_fetch_list=[loss.name, acc.name], epoch=25,
                      log_period=1000)
    strat = pnas.LightNASStrategy(end_epoch=25, search_steps=200)
    comp.strategies = [strat]
    comp.context.put("search_space", ToySpace())
    ctx = comp.run()
    assert ctx.get("nas_best_tokens") is not None
    assert ctx.get("nas_best_reward") > -20
    assert not strat._server._thread.is_alive()


def test_a_server_without_clients_closes_in_bounded_time():
    import time
    server = pnas.ControllerServer(
        controller=pnas.SAController(range_table=[2]))
    server.start()
    assert server.port() > 0
    t0 = time.perf_counter()
    server.close()
    assert time.perf_counter() - t0 < 2 * pnas.ControllerServer.poll + 1
    assert not server._thread.is_alive()


def test_load_params_keeps_the_pruned_zeros():
    """apply_prune_masks writes where the weights live: a pruned weight
    read back through load_params_from_numpy stays pruned."""
    sc = pt.Scope()
    w = np.arange(12, dtype=np.float32).reshape(3, 4) - 5
    load_params_from_numpy(sc, {"w": w}, pt.CPUPlace())
    masks = pprune.StructuredPruner(scope=sc).prune(None, ["w"], [0.5])
    got = np.asarray(sc.find_var("w").get_tensor())
    assert (got == 0).all(axis=0).sum() == 2
    pprune.apply_prune_masks(sc, masks)
    np.testing.assert_array_equal(np.asarray(sc.find_var("w").get_tensor()),
                                  got)
