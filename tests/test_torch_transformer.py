"""The port's Transformer inference slice against the JAX package.

The JAX package builds and initializes a tiny fused Transformer (2+2
layers, d_model 32, 4 heads, d_inner 64, vocab 64); its parameters are
carried into the port with io.load_params_from_numpy; the port builds the
same Program with its own layers. Both score the same ragged batch, with
the JAX attention on its composed path and, separately, on its Pallas
kernel in interpret mode.

Tolerance: 1e-5 absolute and relative on logits and cost. Both sides run
float32 on the CPU; they differ only in the order of float32 sums (XLA
vs torch matmul, softmax and layer-norm reductions) through 4 layers.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.models import transformer as jax_transformer

import paddle_tpu_torch as pt
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.models import transformer as pt_transformer
from torch_threads import one_torch_thread  # noqa: F401

fa = importlib.import_module("paddle_tpu.kernels.flash_attention")

RTOL = ATOL = 1e-5
B, S_SRC, S_TRG = 4, 16, 12
SRC_LENS = np.array([16, 11, 7, 13], np.int32)
TRG_LENS = np.array([12, 9, 5, 12], np.int32)


def _cfg(mod):
    cfg = mod.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                               fuse_attention=True)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    return cfg


def _batch(mod, cfg, seed):
    return mod.make_batch(cfg, B, S_SRC, S_TRG,
                          rng=np.random.default_rng(seed),
                          src_lens=SRC_LENS, trg_lens=TRG_LENS)


def _jax_build():
    cfg = _cfg(jax_transformer)
    fluid.framework.unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        cost, logits, _ = jax_transformer.transformer_train(cfg,
                                                            is_test=True)
    return cfg, main, startup, cost, logits


def _pt_build():
    cfg = _cfg(pt_transformer)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, logits, _ = pt_transformer.transformer_train(cfg,
                                                           is_test=True)
    return cfg, main, startup, cost, logits


def _jax_run(seeds):
    """JAX forward from its own initialization: (params, outputs)."""
    cfg, main, startup, cost, logits = _jax_build()
    scope = JaxScope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    params = {p.name: np.asarray(scope.find_var(p.name).get_tensor())
              for p in main.all_parameters()}
    outs = [exe.run(main, feed=_batch(jax_transformer, cfg, s),
                    fetch_list=[logits, cost], scope=scope)
            for s in seeds]
    return params, [(np.asarray(l), float(np.asarray(c))) for l, c in outs]


def _pt_run(params, seeds):
    cfg, main, startup, cost, logits = _pt_build()
    scope = pt.Scope()
    place = pt.CPUPlace()
    load_params_from_numpy(scope, params, place)
    exe = pt.Executor(place)
    return [exe.run(main, feed=_batch(pt_transformer, cfg, s),
                    fetch_list=[logits, cost], scope=scope)
            for s in seeds]


def test_same_program_op_for_op():
    _, jmain, jstartup, jcost, jlogits = _jax_build()
    _, pmain, pstartup, pcost, plogits = _pt_build()
    for jp, pp in ((jmain, pmain), (jstartup, pstartup)):
        assert [o.type for o in pp.global_block().ops] == \
            [o.type for o in jp.global_block().ops]
    jattn = [o for o in jmain.global_block().ops
             if o.type == "fused_attention"]
    pattn = [o for o in pmain.global_block().ops
             if o.type == "fused_attention"]
    assert [o.all_attrs() for o in pattn] == [o.all_attrs() for o in jattn]
    assert sorted(p.name for p in pmain.all_parameters()) == \
        sorted(p.name for p in jmain.all_parameters())
    assert plogits.shape == jlogits.shape == (-1, -1, 64)


def test_make_batch_matches():
    jb = _batch(jax_transformer, _cfg(jax_transformer), 5)
    pb = _batch(pt_transformer, _cfg(pt_transformer), 5)
    assert sorted(jb) == sorted(pb)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])


@pytest.mark.parametrize("jax_attention", ["composed", "interpret"])
def test_logits_and_cost_match_jax(jax_attention, monkeypatch):
    if jax_attention == "interpret":
        # the JAX op takes its Pallas kernel path (_fa_forward)
        monkeypatch.setattr(fa, "_INTERPRET", True)
    seeds = (3, 4)
    params, jouts = _jax_run(seeds)
    kreg.reset_counts()
    pouts = _pt_run(params, seeds)
    assert kreg.launches()["flash_attention_fwd"] == 0   # CPU: plain
    for (jl, jc), (pl, pc) in zip(jouts, pouts):
        assert pl.shape == jl.shape == (B, S_TRG, 64)
        assert np.isfinite(pl).all() and np.isfinite(pc)
        np.testing.assert_allclose(pl, jl, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(pc), jc, rtol=RTOL, atol=ATOL)


def test_port_startup_initializes_every_parameter():
    _, main, startup, cost, logits = _pt_build()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    startup.random_seed = 7
    exe.run(startup, scope=scope)
    for p in main.all_parameters():
        arr = np.asarray(scope.find_var(p.name).get_tensor())
        assert arr.shape == p.shape and arr.dtype == np.float32
        if p.name.endswith("_ln.w_0"):
            np.testing.assert_array_equal(arr, 1.0)
        elif p.name.endswith(".b_0"):
            np.testing.assert_array_equal(arr, 0.0)
    emb = np.asarray(scope.find_var("src_word_emb.w_0").get_tensor())
    assert abs(emb.std() - 32 ** -0.5) < 0.02
    # same seed, same parameters; the run then scores a batch
    scope2 = pt.Scope()
    exe.run(startup, scope=scope2)
    np.testing.assert_array_equal(
        np.asarray(scope2.find_var("trg_proj.w_0").get_tensor()),
        np.asarray(scope.find_var("trg_proj.w_0").get_tensor()))
    cfg = _cfg(pt_transformer)
    lg, c = exe.run(main, feed=_batch(pt_transformer, cfg, 1),
                    fetch_list=[logits, cost], scope=scope)
    assert lg.shape == (B, S_TRG, 64) and np.isfinite(c)
    assert abs(float(c) - np.log(64)) < 0.5   # near-uniform predictions


def test_run_without_startup_names_missing_params():
    _, main, _, cost, _ = _pt_build()
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(RuntimeError, match="src_word_emb.w_0"):
        exe.run(main, feed=_batch(pt_transformer, _cfg(pt_transformer), 1),
                fetch_list=[cost], scope=pt.Scope())
