"""Card-only tests of paddle_tpu_torch: each kernel against its plain
PyTorch version on the GPU, and a tiny Transformer on the card against
the same Program on the CPU. They skip where torch sees no CUDA device.

This file imports no JAX (the machine with the card has none), so run it
there without the shared conftest:
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: float32 1e-5 relative and absolute (float32 sums in another
order); bf16 2e-2 (p and out round to bf16).
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
BF16_TOL = 2e-2


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
    q, k, v, b = _inputs(cuda, torch.float32, "bshd", 2, 2, 16, 16, 8,
                         "key_pad", False)
    kreg.reset_counts()
    with pytest.raises(NotImplementedError, match="dropout"):
        pfa.fused_attention_forward(q, k, v, b, 0.25, False, "bshd",
                                    dropout_prob=0.1)
    assert kreg.launches()["flash_attention_fwd"] == 0


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
