"""Wide&Deep and DeepFM CTR models (BASELINE config 4), counterpart of
paddle_tpu/models/wide_deep.py, with its parameter names and
initializers.

Inputs are dense [B, num_slots] int32 slot ids (hashed into one shared
id space on the host) and, for Wide&Deep, [B, num_dense] float32
features. The embedding tables are dense [vocab, dim] parameters; with
is_sparse=True their gradient is a SelectedRows of the looked-up rows
(core/selected_rows.py) and the optimizer updates only those rows,
instead of a dense [vocab, dim] gradient and a pass over the whole
table.
"""
from __future__ import annotations

from .. import layers
from ..initializer import Constant, Normal, Uniform
from ..param_attr import ParamAttr


def wide_deep(slot_ids, dense_feat, vocab_size=1000001, embed_dim=16,
              deep_layers=(400, 400, 400), is_sparse=False):
    """slot_ids: [B, num_slots] int32; dense_feat: [B, num_dense]
    float32 or None. Returns the logit [B, 1]."""
    # deep: one shared table, the slots looked up together, flattened
    emb = layers.embedding(
        slot_ids, size=[vocab_size, embed_dim], is_sparse=is_sparse,
        param_attr=ParamAttr(name="ctr_emb.w_0",
                             initializer=Normal(0.0, 0.01)))
    deep = layers.flatten(emb, axis=1)
    if dense_feat is not None:
        deep = layers.concat([deep, dense_feat], axis=1)
    for i, width in enumerate(deep_layers):
        deep = layers.fc(deep, width, act="relu",
                         param_attr=ParamAttr(name=f"ctr_deep_{i}.w_0"),
                         bias_attr=ParamAttr(name=f"ctr_deep_{i}.b_0"))
    deep_logit = layers.fc(deep, 1,
                           param_attr=ParamAttr(name="ctr_deep_out.w_0"),
                           bias_attr=ParamAttr(name="ctr_deep_out.b_0"))
    # wide: a scalar weight an id, a linear model over the sparse ids
    wide_w = layers.embedding(
        slot_ids, size=[vocab_size, 1], is_sparse=is_sparse,
        param_attr=ParamAttr(name="ctr_wide.w_0",
                             initializer=Constant(0.0)))
    wide_logit = layers.reduce_sum(wide_w, dim=[1])
    if dense_feat is not None:
        wide_logit = layers.elementwise_add(
            wide_logit,
            layers.fc(dense_feat, 1,
                      param_attr=ParamAttr(name="ctr_wide_dense.w_0"),
                      bias_attr=False))
    return layers.elementwise_add(deep_logit, wide_logit)


def deepfm(slot_ids, vocab_size=1000001, embed_dim=16,
           deep_layers=(400, 400)):
    """DeepFM on [B, S] ids: first-order weights, the FM second-order
    term and a deep tower. Returns the logit [B, 1]."""
    first = layers.embedding(
        slot_ids, size=[vocab_size, 1],
        param_attr=ParamAttr(name="fm_first.w_0",
                             initializer=Constant(0.0)))
    first_logit = layers.reduce_sum(first, dim=[1])

    emb = layers.embedding(
        slot_ids, size=[vocab_size, embed_dim],
        param_attr=ParamAttr(name="fm_emb.w_0",
                             initializer=Uniform(-0.01, 0.01)))
    # FM: 0.5 * sum((sum_i v_i)^2 - sum_i v_i^2)
    sum_emb = layers.reduce_sum(emb, dim=[1])
    sum_sq = layers.elementwise_mul(sum_emb, sum_emb)
    sq = layers.elementwise_mul(emb, emb)
    sq_sum = layers.reduce_sum(sq, dim=[1])
    fm = layers.scale(layers.elementwise_sub(sum_sq, sq_sum), scale=0.5)
    fm_logit = layers.reduce_sum(fm, dim=[1], keep_dim=True)

    deep = layers.flatten(emb, axis=1)
    for i, width in enumerate(deep_layers):
        deep = layers.fc(deep, width, act="relu",
                         param_attr=ParamAttr(name=f"fm_deep_{i}.w_0"),
                         bias_attr=ParamAttr(name=f"fm_deep_{i}.b_0"))
    deep_logit = layers.fc(deep, 1,
                           param_attr=ParamAttr(name="fm_deep_out.w_0"),
                           bias_attr=ParamAttr(name="fm_deep_out.b_0"))
    return layers.elementwise_add(
        layers.elementwise_add(first_logit, fm_logit), deep_logit)


def ctr_train(model="wide_deep", vocab_size=1000001, num_slots=26,
              num_dense=13, embed_dim=16):
    """The training graph of `model` ("wide_deep" or "deepfm"): returns
    (mean sigmoid cross-entropy cost, probability, feed names)."""
    slot_ids = layers.data("slot_ids", [-1, num_slots],
                           append_batch_size=False, dtype="int32")
    label = layers.data("ctr_label", [-1, 1], append_batch_size=False,
                        dtype="float32")
    feeds = ["slot_ids", "ctr_label"]
    if model == "wide_deep":
        dense = layers.data("dense_feat", [-1, num_dense],
                            append_batch_size=False, dtype="float32")
        feeds.insert(1, "dense_feat")
        logit = wide_deep(slot_ids, dense, vocab_size, embed_dim)
    else:
        logit = deepfm(slot_ids, vocab_size, embed_dim)
    cost = layers.sigmoid_cross_entropy_with_logits(logit, label)
    avg_cost = layers.mean(cost)
    prob = layers.sigmoid(logit)
    return avg_cost, prob, feeds
