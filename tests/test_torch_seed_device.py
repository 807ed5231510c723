"""The attention kernels' dropout seed as a device tensor, and the random
state of a captured block (core/registry.py GraphRandom), on the CPU.

* dropout_keep_mask from the two elements of a seed tensor equals the
  mask from the same words as ints, the JAX package's dropout_keep_mask
  and its in-kernel _hash_keep, bit for bit.
* The plain attention forward and backward take the seed as a tensor
  ((seed, t)) and give what they give for the same words as ints,
  and what the JAX kernels give in interpret mode.
* ExecContext.seed_tensor: eager, the words of seed_words(); in capture
  mode the block's seed tensor, rewritten by GraphRandom.prepare(r) with
  the words the eager run with index r draws. Generators likewise: each
  draw of a run has its own, re-seeded for each run index, so a second
  draw for the same op uid (a grad op without a record) draws what the
  first drew. A draw no warm-up made is refused after seal().
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu_torch.core.registry import (OP_UID_ATTR, ExecContext,
                                            GraphRandom, RunState, op_seed,
                                            op_seed_words)
from paddle_tpu_torch.kernels import flash_attention as pfa
from torch_threads import one_torch_thread  # noqa: F401

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")

CPU = torch.device("cpu")
# the plain attention against the JAX kernels in interpret mode: float32
# sums in another order (tests/test_torch_flash_attention.py)
RTOL = ATOL = 1e-5

_SEEDS = [(0, 0), (0x12345678, 0x9ABCDEF0), (0xFFFFFFFF, 7)]


def _seed(s0, s1):
    return torch.tensor([s0, s1], dtype=torch.int64)


@pytest.mark.parametrize("s0,s1", _SEEDS)
@pytest.mark.parametrize("B,H,Sq,Sk,t", [(2, 4, 16, 16, 230),
                                         (1, 3, 12, 40, 128),
                                         (3, 2, 33, 7, 1)])
def test_device_seed_mask_is_the_host_seed_mask_and_the_jax_masks(
        s0, s1, B, H, Sq, Sk, t):
    seed = _seed(s0, s1)
    got = pfa.dropout_keep_mask(seed[0], seed[1], B, H, Sq, Sk, t,
                                device=CPU).numpy()
    host = pfa.dropout_keep_mask(s0, s1, B, H, Sq, Sk, t,
                                 device=CPU).numpy()
    jseed = jnp.asarray(np.array([s0, s1], np.uint32).view(np.int32))
    want = np.asarray(jfa.dropout_keep_mask(jseed, B, H, Sq, Sk, t))
    tiles = np.stack([np.asarray(jfa._hash_keep(
        jnp.uint32(s0), jnp.uint32(s1), jnp.uint32(bh), jnp.uint32(0),
        jnp.uint32(0), Sq, Sk, Sk, t)) for bh in range(B * H)])
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tiles.reshape(B, H, Sq, Sk))


def _inputs(seed, layout, B=2, H=4, Sq=16, Sk=16, D=8):
    rng = np.random.default_rng(seed)

    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return rng.standard_normal(shape).astype(np.float32)
    lens = np.maximum(Sk - 5 * np.arange(B), 1)
    b = np.where(np.arange(Sk)[None, :] < lens[:, None], 0.0,
                 -1e9).astype(np.float32)[:, None, None, :]
    return t(Sq), t(Sk), t(Sk), b


@pytest.mark.parametrize("s0,s1,t", [(0x12345678, 0x9ABCDEF0, 230),
                                     (5, 9, 128)])
@pytest.mark.parametrize("layout,causal", [("bshd", False),
                                           ("bhsd", True)])
def test_plain_attention_with_a_device_seed_matches_jax_interpret(
        s0, s1, t, layout, causal, monkeypatch):
    monkeypatch.setattr(jfa, "_INTERPRET", True)
    q, k, v, b = _inputs(6, layout, Sq=12, Sk=16)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(
        np.float32)
    scale = 8 ** -0.5
    jd = (jnp.asarray(np.array([s0, s1], np.uint32)), t)
    jargs = [jnp.asarray(a) for a in (q, k, v, b)]
    jo, jl = jfa._fa_forward(*jargs, scale, 12, 16, return_lse=True,
                             layout=layout, causal=causal, dropout=jd)
    jg = jfa._fa_backward(*jargs, jo, jl, jnp.asarray(g), scale, 12, 16,
                          layout=layout, want_dbias=False, causal=causal,
                          dropout=jd)
    tq, tk, tv, tb, tg = (torch.from_numpy(a) for a in (q, k, v, b, g))
    by_tensor = (_seed(s0, s1), t)
    po, pl = pfa.fused_attention_forward(tq, tk, tv, tb, scale, causal,
                                         layout, return_lse=True,
                                         dropout=by_tensor)
    ho, hl = pfa.fused_attention_forward(tq, tk, tv, tb, scale, causal,
                                         layout, return_lse=True,
                                         dropout=(s0, s1, t))
    assert torch.equal(po, ho) and torch.equal(pl, hl)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    got = pfa.fused_attention_backward(
        tq, tk, tv, tb, po, pl, tg, scale, causal, layout,
        dropout=by_tensor)
    host = pfa.fused_attention_backward(
        tq, tk, tv, tb, po, pl, tg, scale, causal, layout,
        dropout=(s0, s1, t))
    for name, a, h, w in zip(("dq", "dk", "dv"), got, host, jg):
        assert torch.equal(a, h), name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_a_seed_of_the_wrong_form_is_refused():
    q, k, v, b = (torch.from_numpy(a) for a in _inputs(1, "bshd"))
    for seed in (torch.tensor([1, 2], dtype=torch.int32),
                 torch.tensor([1, 2, 3]), (1, 2)):
        with pytest.raises(TypeError, match="seed"):
            pfa.fused_attention_forward(q, k, v, b, 0.25, False, "bshd",
                                        dropout=(seed, 230))


class _Op:
    """An op view with a uid and optionally a fixed seed."""

    def __init__(self, uid, seed=0, type="fused_attention"):
        self.type = type
        self._attrs = {OP_UID_ATTR: uid, "seed": seed}

    def attr(self, name, default=None):
        return self._attrs.get(name, default)

    def input_slots(self):
        return []


def test_seed_tensor_eager_is_the_host_words():
    run = RunState(program_seed=11, run=3)
    ctx = ExecContext(_Op(5), {}, CPU, run)
    words = ctx.seed_words()
    assert words == op_seed_words(op_seed(11, 5, 3))
    assert ctx.seed_tensor().tolist() == list(words)
    assert ctx.seed_tensor().dtype == torch.int64
    meta = ExecContext(_Op(5), {}, torch.device("meta"), run).seed_tensor()
    assert meta.device.type == "meta" and meta.shape == (2,)


def _capture_run(random, r):
    return RunState(program_seed=11, run=r, graph=random)


def test_capture_mode_seed_tensors_follow_the_run_index():
    random = GraphRandom(11, CPU)
    run = _capture_run(random, 0)
    fwd = ExecContext(_Op(5), {}, CPU, run).seed_tensor()
    again = ExecContext(_Op(5), {}, CPU, run).seed_tensor()   # grad op
    fixed = ExecContext(_Op(6, seed=99), {}, CPU, run).seed_tensor()
    assert fwd is not again and len(random.slots) == 3
    with pytest.raises(RuntimeError, match="captured"):
        ExecContext(_Op(5), {}, CPU, run).seed_words()
    random.seal()
    views = list(random.slots.values())
    for r in (0, 1, 7):
        random.prepare(r)
        want = list(op_seed_words(op_seed(11, 5, r)))
        assert views[0].tolist() == want and views[1].tolist() == want
        assert views[2].tolist() == list(op_seed_words(99))
    # a replay's ops get the same tensors
    run = _capture_run(random, 7)
    assert ExecContext(_Op(5), {}, CPU, run).seed_tensor() is views[0]
    assert ExecContext(_Op(5), {}, CPU, run).seed_tensor() is views[1]
    with pytest.raises(RuntimeError, match="no warm-up"):
        ExecContext(_Op(8), {}, CPU, run).seed_tensor()


def test_capture_mode_generators_draw_as_eager_per_run_index():
    random = GraphRandom(11, CPU)
    run = _capture_run(random, 0)
    g1 = ExecContext(_Op(5, type="dropout"), {}, CPU, run).generator()
    g2 = ExecContext(_Op(5, type="dropout"), {}, CPU, run).generator()
    assert g1 is not g2
    random.seal()
    for r in (0, 4):
        random.prepare(r)
        eager = ExecContext(_Op(5, type="dropout"), {}, CPU,
                            RunState(11, r)).generator()
        want = torch.randint(0, 256, (64,), generator=eager)
        assert torch.equal(torch.randint(0, 256, (64,), generator=g1),
                           want)
        assert torch.equal(torch.randint(0, 256, (64,), generator=g2),
                           want)
