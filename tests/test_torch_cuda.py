"""Card-only tests of paddle_tpu_torch: each kernel against its plain
PyTorch version on the GPU (flash-attention forward with and without
dropout, its dq and dk/dv backward, Adam), a tiny Transformer forward on
the card against the same Program on the CPU, and three training steps
of it. They skip where torch sees no CUDA device.

This file imports no JAX (the machine with the card has none), so run it
there without the shared conftest:
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: forward float32 1e-5 relative and absolute (float32 sums in
another order); backward float32 1e-4 (each gradient sums up to S
products of recomputed p, in another order than the plain version's
matmuls); bf16 2e-2 (p, ds and the outputs round to bf16). Adam: at most
ADAM_ULP units in the last place (each operation rounds once in both).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.io import load_params_from_numpy
from paddle_tpu_torch.kernels import flash_attention as pfa
from paddle_tpu_torch.kernels import registry as kreg
from paddle_tpu_torch.models import transformer as T

pytestmark = pytest.mark.cuda

F32_TOL = 1e-5
BWD_F32_TOL = 1e-4
BF16_TOL = 2e-2
ADAM_ULP = 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, layout, B, H, Sq, Sk, D, bias, pad_all, seed=0):
    rng = np.random.default_rng(seed)

    def t(S):
        shape = (B, S, H, D) if layout == "bshd" else (B, H, S, D)
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    q, k, v = t(Sq), t(Sk), t(Sk)
    if bias == "key_pad":
        lens = np.maximum(Sk - 5 * np.arange(B), 1)
        if pad_all:
            lens[-1] = 0
        b = np.where(np.arange(Sk)[None, :] < lens[:, None], 0.0,
                     -1e9).astype(np.float32)[:, None, None, :]
    elif bias == "per_head":
        b = rng.standard_normal((B, H, Sq, Sk)).astype(np.float32)
    else:
        b = None
    return q, k, v, None if b is None else torch.from_numpy(b).to(dev)


_CASES = [
    # (layout, B, H, Sq, Sk, D, bias, causal, pad_all)
    ("bshd", 2, 8, 128, 128, 64, "key_pad", False, False),
    ("bshd", 2, 8, 128, 128, 64, "key_pad", True, False),
    ("bshd", 2, 8, 96, 160, 64, "key_pad", False, False),
    ("bhsd", 2, 4, 64, 80, 64, "per_head", True, False),
    ("bshd", 3, 2, 77, 77, 40, "none", True, False),
    ("bhsd", 2, 2, 33, 130, 128, "key_pad", False, False),
    ("bshd", 3, 4, 64, 64, 64, "key_pad", False, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal,pad_all", _CASES)
def test_kernel_matches_plain_on_card(cuda, dtype, layout, B, H, Sq, Sk, D,
                                      bias, causal, pad_all):
    q, k, v, b = _inputs(cuda, dtype, layout, B, H, Sq, Sk, D, bias,
                         pad_all)
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, D ** -0.5, causal,
                                           layout, return_lse=True)
    torch.cuda.synchronize()
    assert kreg.launches()["flash_attention_fwd"] == 1
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, D ** -0.5, causal,
                                             layout, return_lse=True)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)


def test_wrapper_refuses_dropout_on_cuda(cuda):
    """A keep threshold the kernels do not realize (t >= 256 is no
    dropout, t <= 0 drops all) is refused before any launch."""
    q, k, v, b = _inputs(cuda, torch.float32, "bshd", 2, 2, 16, 16, 8,
                         "key_pad", False)
    kreg.reset_counts()
    for t in (0, 256):
        with pytest.raises(ValueError, match="dropout"):
            pfa.fused_attention_forward(q, k, v, b, 0.25, False, "bshd",
                                        dropout=(1, 2, t))
    assert kreg.launches()["flash_attention_fwd"] == 0


_DROP = [None, (0x12345678, 0x9ABCDEF0, 230), (7, 11, 128)]
_DROP_IDS = ["nodrop", "t230", "t128"]


def _tol(dtype, f32):
    return f32 if dtype == torch.float32 else BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", _DROP[1:], ids=_DROP_IDS[1:])
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal,pad_all", _CASES)
def test_forward_with_dropout_matches_plain_on_card(
        cuda, dtype, dropout, layout, B, H, Sq, Sk, D, bias, causal,
        pad_all):
    q, k, v, b = _inputs(cuda, dtype, layout, B, H, Sq, Sk, D, bias,
                         pad_all, seed=1)
    out, lse = pfa.fused_attention_forward(q, k, v, b, D ** -0.5, causal,
                                           layout, return_lse=True,
                                           dropout=dropout)
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, D ** -0.5, causal,
                                             layout, return_lse=True,
                                             dropout=dropout)
    tol = _tol(dtype, F32_TOL)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", _DROP, ids=_DROP_IDS)
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal,pad_all", _CASES)
def test_backward_matches_plain_on_card(cuda, dtype, dropout, layout, B, H,
                                        Sq, Sk, D, bias, causal, pad_all):
    q, k, v, b = _inputs(cuda, dtype, layout, B, H, Sq, Sk, D, bias,
                         pad_all, seed=2)
    dout = torch.randn(q.shape, device=cuda).to(dtype)
    scale = D ** -0.5
    out, lse = pfa.fused_attention_plain(q, k, v, b, scale, causal, layout,
                                         return_lse=True, dropout=dropout)
    want_dbias = bias == "per_head"
    kreg.reset_counts()
    got = pfa.fused_attention_backward(q, k, v, b, out, lse, dout, scale,
                                       causal, layout, dropout=dropout,
                                       want_dbias=want_dbias)
    torch.cuda.synchronize()
    counts = kreg.launches()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    ref = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, dout,
                                             scale, causal, layout,
                                             dropout=dropout,
                                             want_dbias=want_dbias)
    tol = _tol(dtype, BWD_F32_TOL)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol,
                                   msg=name)


def _ulps(a, b):
    """Distance in units in the last place between float32 tensors."""
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("n", [1, 511, 513, 262144])
def test_adam_matches_plain_on_card(cuda, n):
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    p, g = (torch.randn(n, device=cuda, generator=gen) for _ in range(2))
    m = torch.randn(n, device=cuda, generator=gen) * 0.1
    v = torch.rand(n, device=cuda, generator=gen) * 0.01
    lr_t = torch.tensor([2e-4 * (1 - 0.999 ** 3) ** 0.5 / (1 - 0.9 ** 3)],
                        device=cuda)
    ref = fo.adam_plain(p.clone(), g, m.clone(), v.clone(), lr_t[0], 0.9,
                        0.999, 1e-8)
    kreg.reset_counts()
    got = fo.fused_adam(p, g, m, v, lr_t)
    torch.cuda.synchronize()
    assert kreg.launches()["fused_adam"] == 1
    assert got[0] is p and got[1] is m and got[2] is v   # in place
    for name, a, r in zip(("p", "m", "v"), got, ref):
        assert int(_ulps(a, r).max()) <= ADAM_ULP, name


def test_tiny_transformer_on_card_matches_cpu(cuda):
    cfg = T.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                             fuse_attention=True)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, logits, _ = T.transformer_train(cfg, is_test=True)
    cpu_scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    params = {p.name: np.asarray(cpu_scope.find_var(p.name).get_tensor())
              for p in main.all_parameters()}
    gpu_scope = pt.Scope()
    load_params_from_numpy(gpu_scope, params, pt.CUDAPlace(0))
    feed = T.make_batch(cfg, 4, 40, 24, rng=np.random.default_rng(0),
                        src_lens=np.array([40, 31, 7, 22]),
                        trg_lens=np.array([24, 3, 19, 24]))
    lc, cc = pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=[logits, cost], scope=cpu_scope)
    kreg.reset_counts()
    lg, cg = pt.Executor().run(main, feed=feed, fetch_list=[logits, cost],
                               scope=gpu_scope)
    assert kreg.launches()["flash_attention_fwd"] == 6
    np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cg, cc, rtol=1e-5)


def test_tiny_transformer_training_on_card_matches_cpu(cuda):
    """Three Adam steps of the tiny Transformer (float32, dropout 0) on
    the card against the same Program on the CPU, from the same
    parameters: losses and every parameter and moment within 1e-4."""
    cfg = T.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                             fuse_attention=True, dropout=0.0)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 32, 64
    cfg.n_head, cfg.d_head = 4, 8
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = T.transformer_train(cfg)
        pt.optimizer.AdamOptimizer(learning_rate=2e-3).minimize(cost)
    cpu_scope, gpu_scope = pt.Scope(), pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    persist = [v.name for v in main.global_block().vars.values()
               if v.persistable and cpu_scope.find_var(v.name) is not None]
    load_params_from_numpy(
        gpu_scope, {n: np.asarray(cpu_scope.find_var(n).get_tensor())
                    for n in persist}, pt.CUDAPlace(0))
    feed = T.make_batch(cfg, 4, 16, 12, rng=np.random.default_rng(3),
                        src_lens=np.array([16, 11, 7, 13]),
                        trg_lens=np.array([12, 9, 5, 12]))
    kreg.reset_counts()
    for _ in range(3):
        lc = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                            fetch_list=[cost],
                                            scope=cpu_scope)[0]
        lg = pt.Executor().run(main, feed=feed, fetch_list=[cost],
                               scope=gpu_scope)[0]
        np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-4)
    counts = kreg.launches()
    assert counts["flash_attention_fwd"] == 3 * 6
    assert counts["flash_attention_bwd_dq"] == 3 * 6
    assert counts["flash_attention_bwd_dkv"] == 3 * 6
    assert counts["fused_adam"] == 3 * len(main.all_parameters())
    for n in persist:
        np.testing.assert_allclose(
            np.asarray(gpu_scope.find_var(n).get_tensor()),
            np.asarray(cpu_scope.find_var(n).get_tensor()),
            rtol=1e-4, atol=1e-4, err_msg=n)
