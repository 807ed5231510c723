"""The reference's arguments in the port (queue C's faults C.1-C.3).

* C.3: every public name that both the port and the JAX package export
  from `layers`, `optimizer`, `backward`, `initializer`, `param_attr`,
  `regularizer`, `evaluator`, the package itself, `framework`,
  `executor`, `core.scope`, `dygraph.nn`, `metrics`, `contrib`,
  `contrib.slim` and its five subpackages and `layers.distributions`
  takes the same parameters: names, kinds and defaults, by
  inspect.signature (a class by its __init__ and its public methods).
  So a reference script that passes `act` to elementwise_add, `callbacks`
  to append_backward or `force_cpu` to Constant runs in the port.
* C.1: ParamAttr takes the reference's seven arguments in their order
  and a list; a parameter's learning_rate multiplies its step (half the
  SGD step at 0.5, as in the JAX package); a regularizer builds the JAX
  package's decay ops, a parameter's clip its clip op, and
  minimize(grad_clip=...) in a program raises (the reference applies it
  in dygraph mode only; tests/test_torch_clip.py holds that).
* C.1 (slice 26): every name in the JAX `__all__` of each module above
  (for `layers`, of its submodules) is in the port's, but those a queue-A
  item of ROADMAP.md still lists (QUEUED).
* C.2: sequence_pool MAX over sequences that are all empty gives the JAX
  lowering's pad_value rows.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.core.registry import ExecContext as JaxContext
from paddle_tpu.core.registry import OPS as JAX_OPS
from paddle_tpu.core.scope import Scope as JaxScope

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.registry import ExecContext as PtContext
from paddle_tpu_torch.core.registry import OPS as PT_OPS
from paddle_tpu_torch.io import load_params_from_numpy

from test_torch_ops import _Op
from torch_threads import one_torch_thread  # noqa: F401

# the fewest signatures each module must share (so the test cannot pass
# by comparing nothing)
MIN_CHECKED = {"layers": 321, "optimizer": 110, "backward": 2,
               "initializer": 15, "param_attr": 1, "regularizer": 5,
               "evaluator": 10, "(top level)": 88, "framework": 43,
               "executor": 5, "core.scope": 36, "dygraph.nn": 272,
               "metrics": 29, "contrib": 27, "contrib.slim": 0,
               "contrib.slim.core": 19, "contrib.slim.quantization": 18,
               "contrib.slim.prune": 37, "contrib.slim.distillation": 18,
               "contrib.slim.nas": 27, "layers.distributions": 20}
MODULES = list(MIN_CHECKED)
# names each module must share (the builders of the book's last two
# models and py_func, fluid.gradients, and the builders of the op
# families, the schedules and the value-dependent sequence ops)
FAMILY_BUILDERS = {
    "transpose", "split", "slice", "expand", "one_hot", "label_smooth",
    "clip", "clip_by_norm", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "reduce_all", "reduce_any", "elementwise_max",
    "elementwise_min", "elementwise_pow", "elementwise_mod",
    "elementwise_floordiv", "exp", "sqrt", "rsqrt", "abs", "ceil", "floor",
    "cos", "sin", "round", "reciprocal", "softplus", "softsign",
    "logsigmoid", "gelu", "tanh_shrink", "relu6", "leaky_relu", "elu",
    "swish", "prelu", "brelu", "soft_relu", "maxout", "hard_sigmoid",
    "selu", "pow", "hard_shrink", "softshrink", "thresholded_relu",
    "stanh", "unstack", "pad", "pad2d", "crop", "gather_nd", "scatter",
    "argsort", "argmax", "argmin", "cumsum", "multiplex", "shape", "size",
    "where", "hash", "shard_index", "autoincreased_step_counter", "acos",
    "asin", "atan", "uniform_random", "cast", "zeros_like", "ones_like",
    "range", "linspace", "eye", "diag", "reverse", "isfinite", "has_inf",
    "has_nan", "sums", "create_tensor", "create_parameter", "noam_decay",
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "cosine_decay",
    "linear_lr_warmup", "sequence_erase", "sequence_slice",
    "edit_distance"}
# the nn family's and SSD's builders, and the losses
NN_AND_SSD_BUILDERS = {
    "group_norm", "instance_norm", "data_norm", "log_softmax",
    "l2_normalize", "lrn", "dice_loss", "npair_loss", "sign", "mse_loss",
    "log_loss", "huber_loss", "kldiv_loss", "smooth_l1",
    "margin_rank_loss", "rank_loss", "hinge_loss", "bpr_loss",
    "prior_box", "iou_similarity", "box_coder", "bipartite_match",
    "target_assign", "mine_hard_examples", "multiclass_nms",
    "detection_output", "ssd_loss", "multi_box_head", "detection_map"}
# the builders over ops registered before slice 21 and the conv
# family's builders
CONV_BUILDERS = {
    "mul", "sum", "gaussian_random", "lstm_unit", "gru_unit",
    "merge_selected_rows", "get_tensor_from_selected_rows", "rank",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "pool3d",
    "adaptive_pool2d", "adaptive_pool3d", "image_resize",
    "resize_bilinear", "resize_nearest", "image_resize_short",
    "pixel_shuffle", "space_to_depth", "shuffle_channel", "affine_channel",
    "unfold", "temporal_shift", "spp"}
ONE_STAGE_BUILDERS = {
    "density_prior_box", "anchor_generator", "box_clip",
    "polygon_box_transform", "yolov3_loss", "yolo_box",
    "sigmoid_focal_loss", "retinanet_detection_output",
    "retinanet_target_assign", "box_decoder_and_assign"}
TWO_STAGE_BUILDERS = {
    "roi_align", "roi_pool", "psroi_pool", "rpn_target_assign",
    "generate_proposals", "generate_proposal_labels",
    "generate_mask_labels", "roi_perspective_transform",
    "distribute_fpn_proposals", "collect_fpn_proposals"}
NLP_BUILDERS = {
    "warpctc", "ctc_greedy_decoder", "nce", "hsigmoid",
    "sampled_softmax_with_cross_entropy", "bilinear_tensor_product",
    "chunk_eval", "mean_iou", "auc"}
# slice 25's random builders, fsp_matrix and the distributions
RANDOM_BUILDERS = {
    "uniform_random_batch_size_like", "gaussian_random_batch_size_like",
    "sampling_id", "random_crop", "fsp_matrix", "Normal", "Uniform",
    "Categorical", "MultivariateNormalDiag"}
REQUIRED = {"layers": {"log", "stack", "gather", "beam_search",
                       "beam_search_decode", "linear_chain_crf",
                       "crf_decoding", "py_func"} | FAMILY_BUILDERS |
            NN_AND_SSD_BUILDERS | CONV_BUILDERS | ONE_STAGE_BUILDERS |
            TWO_STAGE_BUILDERS | NLP_BUILDERS | RANDOM_BUILDERS,
            "dygraph.nn": {"Conv2DTranspose", "Conv3D", "Conv3DTranspose",
                           "GroupNorm", "PRelu", "BilinearTensorProduct",
                           "GRUUnit", "NCE"},
            "metrics": {"MetricBase", "CompositeMetric", "Precision",
                        "Recall", "Accuracy", "EditDistance", "Auc"},
            "backward": {"gradients"},
            "optimizer": {"LarsMomentum", "LarsMomentumOptimizer",
                          "Adamax", "AdamaxOptimizer", "DecayedAdagrad",
                          "DecayedAdagradOptimizer", "Adadelta",
                          "AdadeltaOptimizer", "RMSProp",
                          "RMSPropOptimizer", "Ftrl", "FtrlOptimizer",
                          "Lamb", "LambOptimizer"},
            "regularizer": {"L1Decay", "L2Decay", "L1DecayRegularizer",
                            "L2DecayRegularizer",
                            "append_regularization_ops"},
            "evaluator": {"ChunkEvaluator", "EditDistance",
                          "DetectionMAP"},
            # the package's own names (the reference's fluid.*) and the
            # framework's, executor's and scope's
            "(top level)": {"append_backward", "Variable", "Block",
                            "Operator", "Parameter", "name_scope",
                            "get_flags", "set_flags", "cpu_places",
                            "cuda_places", "cuda_pinned_places",
                            "CUDAPinnedPlace", "is_compiled_with_cuda",
                            "LoDTensorArray", "EnforceNotMet", "Scope",
                            "LoDTensor", "global_scope", "scope_guard"},
            "framework": {"grad_var_name", "name_scope", "Variable",
                          "Parameter", "Block", "Operator"},
            "executor": {"Executor", "global_scope", "scope_guard"},
            "core.scope": {"Scope", "LoDTensor", "TensorArray"},
            # slice 25: contrib.slim (its subpackages are the shared
            # names of contrib.slim itself), the three initializers
            "contrib": {"Compressor", "QuantizeTranspiler"},
            "contrib.slim": {"core", "quantization", "prune",
                             "distillation", "nas"},
            "contrib.slim.core": {"Compressor", "Context", "Strategy",
                                  "ConfigFactory", "load_config"},
            "contrib.slim.quantization": {
                "QuantizationTransformPass", "QuantizationFreezePass",
                "ConvertToInt8Pass", "QuantizationStrategy",
                "QuantizeTranspiler"},
            "contrib.slim.prune": {
                "MagnitudePruner", "StructuredPruner", "apply_prune_masks",
                "UniformPruneStrategy", "SensitivePruneStrategy",
                "AutoPruneStrategy"},
            "contrib.slim.distillation": {
                "merge", "l2_loss", "soft_label_loss", "fsp_loss",
                "L2Distiller", "SoftLabelDistiller", "FSPDistiller",
                "DistillationStrategy"},
            "contrib.slim.nas": {"SearchSpaceBase", "SAController",
                                 "ControllerServer", "SearchAgent",
                                 "LightNASStrategy"},
            "layers.distributions": {"Uniform", "Normal", "Categorical",
                                     "MultivariateNormalDiag"},
            "initializer": {"TruncatedNormal", "NumpyArrayInitializer",
                            "Bilinear", "TruncatedNormalInitializer",
                            "BilinearInitializer"}}


# the JAX `__all__` names that queue-A items of ROADMAP.md still list:
# A.5c item 6 (the other optimizers, WeightNormParamAttr), A.8 (the
# reader builders and `batch`), A.7 (layers/collective.py)
QUEUED = {"optimizer": {"DGCMomentumOptimizer", "ExponentialMovingAverage",
                        "ModelAverage", "PipelineOptimizer"},
          "param_attr": {"WeightNormParamAttr"},
          "layers": {"py_reader", "double_buffer", "open_files",
                     "read_file", "shuffle", "create_py_reader_by_data",
                     "random_data_generator", "Preprocessor", "batch",
                     "_allreduce"}}


def _jax_all(module, jmod):
    """The JAX module's `__all__` (for `layers`, its submodules')."""
    if module == "layers":
        import pkgutil
        names = set()
        for info in pkgutil.iter_modules(jmod.__path__):
            sub = importlib.import_module(f"paddle_tpu.layers.{info.name}")
            names |= set(getattr(sub, "__all__", ()))
        return names
    return set(jmod.__all__)


# the modules of MODULES whose JAX counterpart has no `__all__` (their
# shared names are held by REQUIRED)
NO_ALL = {"(top level)", "core.scope", "contrib", "contrib.slim",
          "contrib.slim.quantization"}


@pytest.mark.parametrize("module", [m for m in MODULES if m not in NO_ALL])
def test_jax_all_names_are_in_the_port(module):
    suffix = "" if module == "(top level)" else f".{module}"
    jmod = importlib.import_module(f"paddle_tpu{suffix}")
    pmod = importlib.import_module(f"paddle_tpu_torch{suffix}")
    names = _jax_all(module, jmod)
    queued = QUEUED.get(module, set())
    assert queued <= names, module
    assert not (names - queued) - _public(pmod), module
    assert not queued & _public(pmod), module   # a ported name leaves


def _public(mod):
    names = getattr(mod, "__all__", None) or \
        [n for n in dir(mod) if not n.startswith("_")]
    return {n for n in names if hasattr(mod, n)}


def _callables(name, obj):
    """(qualified name, callable) pairs to compare: a function, or a
    class's __init__ and its public methods."""
    if inspect.isclass(obj):
        yield f"{name}.__init__", obj.__init__
        for m in dir(obj):
            f = getattr(obj, m)
            if not m.startswith("_") and callable(f) and \
                    not inspect.isclass(f):
                yield f"{name}.{m}", f
    elif callable(obj):
        yield name, obj


def _params(fn):
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [(p.name, p.kind, p.default) for p in sig.parameters.values()]


@pytest.mark.parametrize("module", MODULES)
def test_shared_names_take_the_reference_arguments(module):
    suffix = "" if module == "(top level)" else f".{module}"
    jmod = importlib.import_module(f"paddle_tpu{suffix}")
    pmod = importlib.import_module(f"paddle_tpu_torch{suffix}")
    shared = sorted(_public(jmod) & _public(pmod))
    assert shared, module
    assert REQUIRED.get(module, set()) <= set(shared), module
    checked, wrong = 0, {}
    for name in shared:
        jobj, pobj = getattr(jmod, name), getattr(pmod, name)
        if inspect.ismodule(jobj):
            continue
        port = dict(_callables(name, pobj))
        for qual, jfn in _callables(name, jobj):
            if qual not in port:
                continue
            a, b = _params(jfn), _params(port[qual])
            if a is None or b is None:
                continue
            checked += 1
            if a != b:
                wrong[qual] = (a, b)
    assert not wrong, wrong
    assert checked >= MIN_CHECKED[module], checked


# ---------------------------------------------------------------------------
# C.1
# ---------------------------------------------------------------------------

def test_param_attr_takes_the_reference_arguments():
    a = pt.ParamAttr("w", None, 0.5)
    assert (a.name, a.learning_rate, a.trainable) == ("w", 0.5, True)
    b = pt.ParamAttr(name="w", learning_rate=0.25, trainable=False,
                     do_model_average=True)
    assert (b.learning_rate, b.trainable, b.do_model_average) == \
        (0.25, False, True)
    attrs = pt.ParamAttr._to_attr(["a", None, b])
    assert [x.name for x in attrs] == ["a", None, "w"] and attrs[2] is b


def _sgd_program(fl, attr):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", [4], dtype="float32")
        loss = fl.layers.mean(fl.layers.fc(x, 3, param_attr=attr,
                                           bias_attr=False))
        fl.optimizer.SGD(0.1).minimize(loss)
    return main, startup


def test_learning_rate_multiplier_halves_the_step_as_in_jax():
    x = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
    steps = {}
    for lr_mult in (1.0, 0.5):
        jmain, jstart = _sgd_program(
            fluid, fluid.ParamAttr(name="w", learning_rate=lr_mult))
        pmain, pstart = _sgd_program(
            pt, pt.ParamAttr(name="w", learning_rate=lr_mult))
        assert [o.type for o in pmain.global_block().ops] == \
            [o.type for o in jmain.global_block().ops]
        assert pmain.global_block().vars["w"].optimize_attr == \
            {"learning_rate": lr_mult}
        jscope, jexe = JaxScope(), fluid.Executor(fluid.CPUPlace())
        jexe.run(jstart, scope=jscope)
        w0 = np.asarray(jscope.find_var("w").get_tensor())
        pscope, pexe = pt.Scope(), pt.Executor(pt.CPUPlace())
        pexe.run(pstart, scope=pscope)
        load_params_from_numpy(pscope, {"w": w0}, pt.CPUPlace())
        jexe.run(jmain, feed={"x": x}, scope=jscope)
        pexe.run(pmain, feed={"x": x}, scope=pscope)
        jw = np.asarray(jscope.find_var("w").get_tensor())
        pw = np.asarray(pscope.find_var("w").get_tensor())
        np.testing.assert_allclose(pw, jw, rtol=1e-6, atol=1e-7)
        steps[lr_mult] = pw - w0
    # within the rounding of w (|w| < 1: 6e-8) around each step
    np.testing.assert_allclose(steps[0.5], 0.5 * steps[1.0], rtol=1e-5,
                               atol=1e-7)
    assert np.abs(steps[1.0]).max() > 0


def _decayed_program(fl):
    fl.framework.unique_name.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", [4], dtype="float32")
        attr = fl.ParamAttr(name="w",
                            regularizer=fl.regularizer.L2Decay(1e-2))
        loss = fl.layers.mean(fl.layers.fc(x, 3, param_attr=attr))
        fl.optimizer.SGD(0.1).minimize(loss)
    return main


@pytest.mark.parametrize("kind", ["regularizer", "gradient_clip",
                                  "grad_clip"])
def test_regularizer_and_clip_are_never_dropped(kind):
    """A parameter's regularizer reaches its update: the decay ops (scale
    of w, then sum with w@GRAD) the JAX package builds, the same bytes.
    A parameter's gradient_clip builds the JAX package's clip op before
    its update (the same bytes); minimize(grad_clip=...) in a program
    raises (the reference ignores it there, the JAX package drops it)."""
    if kind == "regularizer":
        pmain = _decayed_program(pt)
        assert pmain.serialize_to_string() == \
            _decayed_program(fluid).serialize_to_string()
        ops = pmain.global_block().ops
        scale = [o for o in ops if o.type == "scale"
                 and o.input("X") == ["w"]]
        assert len(scale) == 1 and scale[0].attr("scale") == 1e-2
        sgd = [o for o in ops if o.type == "sgd" and o.input("Param")
               == ["w"]][0]
        summed = [o for o in ops if o.type == "sum" and
                  o.output("Out") == sgd.input("Grad")][0]
        assert summed.input("X") == ["w@GRAD", scale[0].output("Out")[0]]
        return

    def build(fl, clip, **kw):
        fl.framework.unique_name.reset()
        main, startup = fl.Program(), fl.Program()
        attr = fl.ParamAttr(name="w", gradient_clip=clip) \
            if kind == "gradient_clip" else fl.ParamAttr(name="w")
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", [4], dtype="float32")
            loss = fl.layers.mean(fl.layers.fc(x, 3, param_attr=attr))
            fl.optimizer.SGD(0.1).minimize(loss, **kw)
        return main

    if kind == "gradient_clip":
        pmain = build(pt, pt.clip.GradientClipByValue(0.01))
        assert pmain.serialize_to_string() == build(
            fluid, fluid.clip.GradientClipByValue(0.01)
        ).serialize_to_string()
    else:
        for clip in (pt.clip.GradientClipByValue(0.01),
                     pt.dygraph_grad_clip.GradClipByValue(0.01)):
            with pytest.raises(ValueError, match="dygraph mode only"):
                build(pt, None, grad_clip=clip)
        return
    ops = pmain.global_block().ops
    clip = [o for o in ops if o.type == "clip"
            and o.input("X") == ["w@GRAD"]]
    sgd = [o for o in ops if o.type == "sgd" and o.input("Param") ==
           ["w"]][0]
    assert len(clip) == 1 and sgd.input("Grad") == clip[0].output("Out")
    assert clip[0].attr("max") == 0.01


# ---------------------------------------------------------------------------
# C.2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lod", [[0, 0, 0], [0, 0, 0, 0]])
def test_sequence_pool_max_over_empty_sequences(lod):
    op = _Op("sequence_pool", {"X": None}, ["Out", "MaxIndex"],
             {"pooltype": "MAX", "pad_value": 2.0})
    x = np.zeros((0, 3), np.float32)
    jenv, penv = {"x": jnp.asarray(x)}, {"x": torch.from_numpy(x)}
    JAX_OPS.get("sequence_pool").lowering(
        JaxContext(op, jenv, None, None, {"x": [lod]}))
    PT_OPS.get("sequence_pool").lowering(
        PtContext(op, penv, torch.device("cpu"), None, {"x": [lod]}))
    want = np.full((len(lod) - 1, 3), 2.0, np.float32)
    np.testing.assert_array_equal(np.asarray(jenv["out_out"]), want)
    np.testing.assert_array_equal(penv["out_out"].numpy(), want)
