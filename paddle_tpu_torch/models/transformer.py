"""Transformer-base encoder-decoder built with the port's layers.

Counterpart of paddle_tpu/models/transformer.py, on its fused path:
fuse_attention=True (op fused_attention, layout bshd, causal decoder
self-attention through the op attr) and fuse_loss=True (op
label_smoothed_softmax_xent). With is_test=True the Program is the JAX
package's, op for op, and every parameter has the same explicit name, so
parameters initialized by either package load into the other by name.
The composed attention and loss paths, the incremental-decode cache and
dropout layers are not ported yet: the builder refuses configurations
that would need them.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..initializer import Constant, Normal
from ..param_attr import ParamAttr


class TransformerConfig:
    def __init__(self, src_vocab_size=32000, trg_vocab_size=32000,
                 max_length=256, d_model=512, d_inner=2048, n_head=8,
                 n_layer=6, dropout=0.1, label_smooth_eps=0.1,
                 dtype="float32", fuse_attention=False, fuse_loss=True):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.max_length = max_length
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.dropout = dropout
        self.label_smooth_eps = label_smooth_eps
        self.dtype = dtype
        self.fuse_attention = fuse_attention
        self.fuse_loss = fuse_loss
        if d_model % n_head:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_head {n_head}")
        self.d_head = d_model // n_head


def transformer_base(**kw):
    return TransformerConfig(**kw)


def _w(name):
    return ParamAttr(name=name, initializer=Normal(0.0, 0.02))


def _b(name):
    return ParamAttr(name=name, initializer=Constant(0.0))


def _linear(x, size, name, act=None):
    return layers.fc(x, size, num_flatten_dims=2, act=act,
                     param_attr=_w(name + ".w_0"),
                     bias_attr=_b(name + ".b_0"))


def multi_head_attention(q_in, kv_in, attn_bias, cfg: TransformerConfig,
                         name, is_test=False, causal=False):
    """Multi-head attention on the fused bshd path: the projections are
    reshaped for free to [B, S, H, dh] and fed to the fused op, so no
    head transposes exist. attn_bias: [B, 1, 1|Sq, Sk] additive mask."""
    h, dh = cfg.n_head, cfg.d_head
    q = _linear(q_in, cfg.d_model, name + "_q")
    k = _linear(kv_in, cfg.d_model, name + "_k")
    v = _linear(kv_in, cfg.d_model, name + "_v")
    q4 = layers.reshape(q, [0, 0, h, dh])
    k4 = layers.reshape(k, [0, 0, h, dh])
    v4 = layers.reshape(v, [0, 0, h, dh])
    ctx = layers.fused_attention(q4, k4, v4, attn_bias, scale=dh ** -0.5,
                                 layout="bshd", dropout_prob=cfg.dropout,
                                 is_test=is_test, causal=causal)
    ctx = layers.reshape(ctx, [0, 0, cfg.d_model])
    return _linear(ctx, cfg.d_model, name + "_o")


def _ffn(x, cfg: TransformerConfig, name):
    hidden = _linear(x, cfg.d_inner, name + "_fc1", act="relu")
    return _linear(hidden, cfg.d_model, name + "_fc2")


def _pre_post(x, residual, name):
    """post-norm residual block tail: LN(residual + x)."""
    out = layers.elementwise_add(x, residual)
    return layers.layer_norm(
        out, begin_norm_axis=2,
        param_attr=ParamAttr(name=name + "_ln.w_0",
                             initializer=Constant(1.0)),
        bias_attr=ParamAttr(name=name + "_ln.b_0",
                            initializer=Constant(0.0)))


def _embed(ids, vocab_size, cfg, name):
    emb = layers.embedding(
        ids, size=[vocab_size, cfg.d_model],
        param_attr=ParamAttr(name=name,
                             initializer=Normal(0.0, cfg.d_model ** -0.5)),
        dtype=cfg.dtype)
    emb = layers.scale(emb, scale=cfg.d_model ** 0.5)
    return layers.add_position_encoding(emb, alpha=1.0, beta=1.0)


def encoder(src_ids, src_bias, cfg: TransformerConfig, is_test=False):
    x = _embed(src_ids, cfg.src_vocab_size, cfg, "src_word_emb.w_0")
    for i in range(cfg.n_layer):
        p = f"enc_{i}"
        attn = multi_head_attention(x, x, src_bias, cfg, p + "_attn",
                                    is_test)
        x = _pre_post(attn, x, p + "_attn")
        x = _pre_post(_ffn(x, cfg, p + "_ffn"), x, p + "_ffn")
    return x


def decoder(trg_ids, trg_bias, enc_out, cross_bias, cfg, is_test=False):
    x = _embed(trg_ids, cfg.trg_vocab_size, cfg, "trg_word_emb.w_0")
    for i in range(cfg.n_layer):
        p = f"dec_{i}"
        self_attn = multi_head_attention(x, x, trg_bias, cfg,
                                         p + "_self_attn", is_test,
                                         causal=True)
        x = _pre_post(self_attn, x, p + "_self_attn")
        cross = multi_head_attention(x, enc_out, cross_bias, cfg,
                                     p + "_cross_attn", is_test)
        x = _pre_post(cross, x, p + "_cross_attn")
        x = _pre_post(_ffn(x, cfg, p + "_ffn"), x, p + "_ffn")
    return x


def transformer_train(cfg: TransformerConfig, is_test=False):
    """Build the scoring graph. Feeds (dense, host-prepared):
      src_ids   int32 [B, S_src]
      trg_ids   int32 [B, S_trg]        (decoder input, shifted right)
      lbl_ids   int32 [B, S_trg]        (decoder target)
      src_bias  f32   [B, 1, 1, S_src]  additive key-padding mask
      trg_bias  f32   [B, 1, 1, S_trg]  key-padding mask (causal is the
                                        fused op's attr)
      lbl_w     f32   [B, S_trg]        per-token loss weight (non-pad=1)
    Returns (avg_cost, logits, feed_names)."""
    if not (cfg.fuse_attention and cfg.fuse_loss and cfg.label_smooth_eps):
        raise NotImplementedError(
            "paddle_tpu_torch builds the fused Transformer only "
            "(fuse_attention=True, fuse_loss=True, label_smooth_eps > 0)")
    if cfg.dropout and not is_test:
        raise NotImplementedError(
            "dropout is not ported yet: build with is_test=True or "
            "dropout=0")

    def _data(name, shape, dtype):
        return layers.data(name, shape, append_batch_size=False,
                           dtype=dtype)

    src_ids = _data("src_ids", [-1, -1], "int32")
    trg_ids = _data("trg_ids", [-1, -1], "int32")
    lbl_ids = _data("lbl_ids", [-1, -1], "int32")
    src_bias = _data("src_bias", [-1, 1, 1, -1], cfg.dtype)
    trg_bias = _data("trg_bias", [-1, 1, 1, -1], cfg.dtype)
    lbl_w = _data("lbl_w", [-1, -1], cfg.dtype)

    enc_out = encoder(src_ids, src_bias, cfg, is_test)
    dec_out = decoder(trg_ids, trg_bias, enc_out, src_bias, cfg, is_test)
    logits = layers.fc(dec_out, cfg.trg_vocab_size, num_flatten_dims=2,
                       param_attr=_w("trg_proj.w_0"), bias_attr=False)
    cost = layers.label_smoothed_softmax_xent(
        logits, lbl_ids, epsilon=cfg.label_smooth_eps)
    cost = layers.squeeze(cost, axes=[-1])
    weighted = layers.elementwise_mul(cost, lbl_w)
    sum_cost = layers.reduce_sum(weighted)
    token_count = layers.reduce_sum(lbl_w)
    avg_cost = layers.elementwise_div(sum_cost, token_count)
    feeds = ["src_ids", "trg_ids", "lbl_ids", "src_bias", "trg_bias",
             "lbl_w"]
    return avg_cost, logits, feeds


def make_batch(cfg, batch, s_src, s_trg, rng=None, src_lens=None,
               trg_lens=None):
    """Host-side dense batch: random ids, and padding masks as additive
    biases of -1e9 (the JAX package's constant)."""
    rng = rng or np.random.default_rng(0)
    src_lens = src_lens if src_lens is not None else \
        np.full((batch,), s_src, np.int32)
    trg_lens = trg_lens if trg_lens is not None else \
        np.full((batch,), s_trg, np.int32)
    src_ids = rng.integers(1, cfg.src_vocab_size, (batch, s_src),
                           dtype=np.int32)
    trg_ids = rng.integers(1, cfg.trg_vocab_size, (batch, s_trg),
                           dtype=np.int32)
    lbl_ids = rng.integers(1, cfg.trg_vocab_size, (batch, s_trg),
                           dtype=np.int32)
    src_mask = np.arange(s_src)[None, :] < src_lens[:, None]
    trg_mask = np.arange(s_trg)[None, :] < trg_lens[:, None]
    neg = np.float32(-1e9)
    src_bias = np.where(src_mask, 0.0, neg).astype(np.float32)
    trg_bias = np.where(trg_mask, 0.0, neg).astype(np.float32)
    return {"src_ids": src_ids, "trg_ids": trg_ids, "lbl_ids": lbl_ids,
            "src_bias": src_bias[:, None, None, :],
            "trg_bias": trg_bias[:, None, None, :],
            "lbl_w": trg_mask.astype(np.float32)}
