"""Card-only tests of paddle_tpu_torch: each kernel against its plain
PyTorch version on the GPU (flash-attention forward with and without
dropout, its dq and dk/dv backward, head dims from 1 up (264, 320 and 512
included), the bf16 tensor-core forward, dq (di fused in) and dk/dv
kernels and one wgmma product of each kind they use, the float32
tensor-core (3xTF32) forward, the registry's deny list, Adam and SGD
(one parameter, and lists of them in one launch: several Adam steps,
the beta powers and more than one table a list),
quantized_matmul int8 and bf16, every tuned_matmul variant of both
designs and the tensor-core tiles at the serving shapes, the
dropout_residual ones among them), a tiny
Transformer forward on the card against the same Program on the CPU
(float32 and int8 mode), three training steps of it, LeNet's SGD
step with its updates in the kernel against the same step with them
plain, one bf16 AMP step of ResNet-50 at 224x224, training steps of
LeNet and the tiny Transformer with and without the engine's plan cache
(bit-equal), the sparse (SelectedRows) update of sgd, momentum, adagrad
and adam against the same update on the CPU (with no host sync, and
parked slots, padding_idx rows and merge slack, touching no row and
firing no device assert), Wide&Deep at vocab 1001 with dense and
with sparse embedding gradients, and the engine's captured blocks
(ResNet-50's bottlenecks at stages [1, 1, 1, 1] and the tiny
Transformer with dropout: captured runs bit-equal to eager ones; the
attention kernels reading their dropout seed from the card, also
inside a CUDA graph; a host copy inside a captured block raising; a
capture after every graph of an engine was released), and the serving
engine (the book LM's signatures captured by warmup(), a burst of
replays only with each request's tokens equal to its solo run, 37
GEMM-kernel launches a dispatch in bf16 and int8 mode, ServeServer's
threads against the in-process engine), and the book's CRF tagger and
beam-search decoder captured against eager bit for bit (the decoder in
float32 and with its step GEMMs in the int8 and bf16 kernels, their
launches counted), and the bucket sweep kernels against their
plain version (every ZeRO-1 window of 4, the guard's gate, weight decay,
views off a 16-byte boundary, window edges inside a kernel's chunk, a
16,384,000-element bucket; a captured sweep replayed with new beta
powers and shard index; one kernel a call under the profiler and
in a captured graph's nodes),
flash_attention_lse with an lse
cotangent, every case of ops/family_cases.py on the card against the
CPU, full-width MobileNet-SSD (chip_smoke.mobilenet_ssd, B=8) captured
against eager bit for bit, multiclass_nms at 64 x 21 x 1917 against the
CPU, the update ops without a kernel against the CPU, the conv family's
cases forward and backward against the CPU, the transposed
convolutions under AMP, full-width SimpleBaseline (chip_smoke.pose_resnet,
B=4) captured against eager bit for bit, a resize by an OutSize input
kept eager, the one- and two-stage detection ops' cases against the CPU,
roi_align's gradient deterministic, and full-width YOLOv3, the RetinaNet
head and Faster R-CNN (B=1) captured against eager bit for bit, slice
24's nlp and metric ops' cases with their gradients against the CPU,
full-width CRNN-CTC (B=4) and the sampled heads over 32000 classes
captured against eager bit for bit. They skip where torch sees no CUDA
device.

This file imports no JAX (the machine with the card has none), so run it
there without the shared conftest:
    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: forward float32 1e-5 relative and absolute (float32 sums in
another order); backward float32 1e-4 (each gradient sums up to S
products of recomputed p, in another order than the plain version's
matmuls); bf16 2e-2 (p, ds and the outputs round to bf16), except where
a row's keys are all padded: there p = 1 on every key, |ds| is in the
tens, and every bf16 gradient is held to the bound a correct bf16 kernel
meets against the exact gradients (flash_attention.bf16_backward_bound:
2^-8 of ds's or p_drop's contribution and of the float32 result, plus
2^-12 of the magnitudes of the float32 dot products); bf16 gradients at
head dims above 256 are held to both. Adam: 0 units in the last place
(ADAM_ULP: each operation rounds once in both, in the same order);
SGD: 0 ulp (the same two roundings, lr*g and the difference). Sparse
updates against the CPU: SPARSE_TOL (duplicate rows summed in another
order by the card's atomics; the CPU's vectorized sqrt is 1 ulp off in
places). A row looked up k = 2048 times is summed in an order the
atomics leave open: the merged slices to 2 k 2^-24 of the sum of the
magnitudes added (the worst case of two summation orders), sgd's
parameter row likewise over |p| and lr times the slices; the other
updates are then held to SPARSE_TOL on the merged gradient. Wide&Deep
sparse against dense: see CTR_TINY_G.
quantized_matmul int8: bit-equal (exact integer tile sums, the same two
roundings a tile); bf16 and the tuned float32 GEMMs: GEMM_RTOL relative
in the norm (float32 sums in another order).
"""
import contextlib

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
ADAM_ULP = 0
GEMM_RTOL = 1e-5
SPARSE_TOL = 1e-6
# Wide&Deep, sparse against dense after 3 steps, elementwise RTOL/ATOL
# 1e-5 but where every gradient an element saw stayed below CTR_TINY_G:
# Adagrad's lr*g/(|g| + 1e-6) magnifies the rounding of such a cancelling
# gradient, and those are held to CTR_TINY_G_ATOL (as
# tests/test_torch_ctr.py holds the port to the JAX package)
CTR_TINY_G, CTR_TINY_G_ATOL = 1e-4, 1e-4


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
    bounded = dtype == torch.bfloat16 and pad_all
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        if not (bounded and name != "dbias"):
            torch.testing.assert_close(g.float(), r.float(), rtol=tol,
                                       atol=tol, msg=name)
    if bounded:
        _assert_within_bound(got[:3], q, k, v, b, out, lse, dout, scale,
                             causal, layout, dropout)


def _assert_within_bound(grads, q, k, v, b, out, lse, dout, scale, causal,
                         layout, dropout):
    """dq, dk, dv within flash_attention.bf16_backward_bound of the exact
    gradients, elementwise."""
    exact, bound = pfa.bf16_backward_bound(q, k, v, b, out, lse, dout, scale,
                                           causal, layout, dropout)
    for name, g, e, bd in zip(("dq", "dk", "dv"), grads, exact, bound):
        excess = ((g.double() - e).abs() - bd).max().item()
        assert excess <= 0, f"{name} beyond its bound by {excess:.3e}"


# the tensor-core kernels (bf16): chip_smoke.py's case list
_SM90_CASES = [
    # (layout, B, H, Sq, Sk, D, bias, causal, pad_all)
    ("bshd", 4, 8, 256, 256, 64, "key_pad", False, False),
    ("bshd", 4, 8, 256, 256, 64, "key_pad", True, False),
    ("bshd", 4, 8, 192, 256, 64, "key_pad", False, False),
    ("bhsd", 2, 8, 128, 160, 64, "per_head", True, False),
    ("bshd", 3, 4, 77, 77, 96, "key_pad", True, False),
    ("bhsd", 2, 3, 50, 130, 128, "key_pad", False, False),
    ("bshd", 4, 8, 128, 128, 64, "key_pad", False, True),
    ("bshd", 32, 8, 256, 256, 64, "key_pad", False, False),
    ("bshd", 32, 8, 256, 256, 64, "key_pad", True, False),
    ("bshd", 96, 8, 128, 128, 64, "key_pad", False, False),
    ("bshd", 96, 8, 128, 128, 64, "key_pad", True, False),
]


def test_sm90_wgmma_probe_matches_matmul_on_card(cuda):
    """One m64n64k16 product of each kind the tensor-core kernels use,
    through TMA's 128-byte swizzle: A.B^T with both operands K-major in
    shared memory, then bf16(A.B^T).B with A from registers and B
    MN-major, against torch.matmul of the same bf16 values in float32
    (sums in another order only)."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(cuda, torch.bfloat16) for _ in range(2))
    c, r = pfa.wgmma_probe(a, b)
    torch.cuda.synchronize()
    want_c = a.float() @ b.float().T
    torch.testing.assert_close(c, want_c, rtol=1e-5, atol=1e-4)
    want_r = c.to(torch.bfloat16).float() @ b.float()
    torch.testing.assert_close(r, want_r, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dropout", _DROP, ids=_DROP_IDS)
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal,pad_all",
                         _SM90_CASES)
def test_sm90_forward_matches_plain_on_card(cuda, dropout, layout, B, H, Sq,
                                            Sk, D, bias, causal, pad_all):
    q, k, v, b = _inputs(cuda, torch.bfloat16, layout, B, H, Sq, Sk, D, bias,
                         pad_all, seed=3)
    assert pfa._sm90_eligible(q, k, v, q, layout)
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, D ** -0.5, causal,
                                           layout, return_lse=True,
                                           dropout=dropout)
    torch.cuda.synchronize()
    counts = kreg.launches()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_fwd_sm90"] == 1
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, D ** -0.5, causal,
                                             layout, return_lse=True,
                                             dropout=dropout)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("dropout", _DROP, ids=_DROP_IDS)
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal,pad_all",
                         _SM90_CASES)
def test_sm90_dkv_matches_plain_on_card(cuda, dropout, layout, B, H, Sq, Sk,
                                        D, bias, causal, pad_all):
    q, k, v, b = _inputs(cuda, torch.bfloat16, layout, B, H, Sq, Sk, D, bias,
                         pad_all, seed=4)
    # dO from a seed of its own, as q, k, v are made (not from the global
    # CUDA generator, whose draw depends on the tests run before)
    dout = torch.from_numpy(np.random.default_rng(14).standard_normal(
        q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    scale = D ** -0.5
    out, lse = pfa.fused_attention_plain(q, k, v, b, scale, causal, layout,
                                         return_lse=True, dropout=dropout)
    kreg.reset_counts()
    got = pfa.fused_attention_backward(q, k, v, b, out, lse, dout, scale,
                                       causal, layout, dropout=dropout)
    torch.cuda.synchronize()
    counts = kreg.launches()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["flash_attention_bwd_dkv_sm90"] == 1
    ref = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, dout,
                                             scale, causal, layout,
                                             dropout=dropout)
    for name, g, r in zip(("dk", "dv"), got[1:3], ref[1:3]):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert r.abs().max() > 0, name                 # not vacuous
        if not pad_all:
            torch.testing.assert_close(g.float(), r.float(), rtol=BF16_TOL,
                                       atol=BF16_TOL, msg=name)
    if pad_all:
        _assert_within_bound(got[:3], q, k, v, b, out, lse, dout, scale,
                             causal, layout, dropout)


@pytest.mark.parametrize("dropout", _DROP, ids=_DROP_IDS)
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal,pad_all",
                         _SM90_CASES)
def test_sm90_dq_matches_plain_on_card(cuda, dropout, layout, B, H, Sq, Sk,
                                       D, bias, causal, pad_all):
    """The tensor-core dq kernel (di fused in: the dk/dv kernel after it
    reads the di it wrote), with the per-element bias gradient where the
    bias is per head."""
    q, k, v, b = _inputs(cuda, torch.bfloat16, layout, B, H, Sq, Sk, D, bias,
                         pad_all, seed=6)
    dout = torch.from_numpy(np.random.default_rng(16).standard_normal(
        q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    scale = D ** -0.5
    want_dbias = bias == "per_head"
    out, lse = pfa.fused_attention_plain(q, k, v, b, scale, causal, layout,
                                         return_lse=True, dropout=dropout)
    kreg.reset_counts()
    got = pfa.fused_attention_backward(q, k, v, b, out, lse, dout, scale,
                                       causal, layout, dropout=dropout,
                                       want_dbias=want_dbias)
    torch.cuda.synchronize()
    counts = kreg.launches()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dq_sm90"] == 1
    assert counts["flash_attention_bwd_dkv_sm90"] == 1
    ref = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, dout,
                                             scale, causal, layout,
                                             dropout=dropout,
                                             want_dbias=want_dbias)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert g is None, name
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        assert torch.isfinite(g.float()).all(), name
        assert r.abs().max() > 0, name                 # not vacuous
        if not pad_all or name == "dbias":
            torch.testing.assert_close(g.float(), r.float(), rtol=BF16_TOL,
                                       atol=BF16_TOL, msg=name)
    if pad_all:
        _assert_within_bound(got[:3], q, k, v, b, out, lse, dout, scale,
                             causal, layout, dropout)


@pytest.mark.parametrize("design", ["sm90", "simt", "plain"])
@pytest.mark.parametrize("dropout", _DROP, ids=_DROP_IDS)
def test_all_padded_rows_meet_the_bf16_bound_on_card(cuda, monkeypatch,
                                                     design, dropout):
    """Rows whose keys all carry a -1e9 bias have p = 1 on every key and
    |ds| in the tens: over 40 seeded draws of dO, each bf16 design's dq,
    dk and dv (and the plain version's) stay within the derived bound of
    the exact gradients (flash_attention.bf16_backward_bound), and the
    bound there is wider than BF16_TOL (the case is not vacuous)."""
    if design == "simt":
        monkeypatch.setattr(pfa, "_sm90_eligible", lambda *a: False)
    B, H, S, D = 4, 8, 128, 64
    q, k, v, b = _inputs(cuda, torch.bfloat16, "bshd", B, H, S, S, D,
                         "key_pad", True, seed=9)
    scale = D ** -0.5
    out, lse = pfa.fused_attention_plain(q, k, v, b, scale, False, "bshd",
                                         return_lse=True, dropout=dropout)
    widest = 0.0
    for seed in range(40):
        dout = torch.from_numpy(np.random.default_rng(1000 + seed)
                                .standard_normal(q.shape).astype(np.float32)
                                ).to(cuda, torch.bfloat16)
        kreg.reset_counts()
        if design == "plain":
            grads = pfa.fused_attention_backward_plain(
                q, k, v, b, out, lse, dout, scale, False, "bshd",
                dropout=dropout)
        else:
            grads = pfa.fused_attention_backward(
                q, k, v, b, out, lse, dout, scale, False, "bshd",
                dropout=dropout)
            torch.cuda.synchronize()
            assert kreg.launches()["flash_attention_bwd_dq_sm90"] == \
                int(design == "sm90")
        _assert_within_bound(grads[:3], q, k, v, b, out, lse, dout, scale,
                             False, "bshd", dropout)
        _, bound = pfa.bf16_backward_bound(q, k, v, b, out, lse, dout, scale,
                                           False, "bshd", dropout)
        widest = max(widest, bound[0][-1].max().item())
    assert widest > BF16_TOL


def test_misaligned_bf16_takes_the_cuda_core_kernels_on_card(cuda):
    """A bf16 call whose q starts 2 bytes past a 16-byte boundary breaks
    TMA's rules: the CUDA-core kernels run it, and agree with the plain
    version."""
    B, S, H, D = 2, 64, 4, 64
    n = B * S * H * D
    base = torch.randn(n + 1, device=cuda).to(torch.bfloat16)
    q = base[1:].view(B, S, H, D)
    _, k, v, b = _inputs(cuda, torch.bfloat16, "bshd", B, H, S, S, D,
                         "key_pad", False)
    assert not pfa._sm90_eligible(q, k, v, k, "bshd")
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, D ** -0.5, False,
                                           "bshd", return_lse=True)
    dq, dk, dv, _ = pfa.fused_attention_backward(
        q, k, v, b, out, lse, out, D ** -0.5, False, "bshd")
    torch.cuda.synchronize()
    counts = kreg.launches()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["flash_attention_fwd_sm90"] == 0
    assert counts["flash_attention_bwd_dq_sm90"] == 0
    assert counts["flash_attention_bwd_dkv_sm90"] == 0
    ref = pfa.fused_attention_plain(q, k, v, b, D ** -0.5, False, "bshd")
    torch.testing.assert_close(out.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("deny", ["deny_list", "flag_off"])
def test_denied_attention_launches_no_kernel_on_card(cuda, monkeypatch,
                                                     deny):
    """Under PT_KERNEL_DENY=flash_attention or FLAGS_use_custom_kernels=0
    the attention entry points run the plain (composed) version, count
    the call `denied` and launch nothing."""
    from paddle_tpu_torch.core.flags import set_flags
    q, k, v, b = _inputs(cuda, torch.bfloat16, "bshd", 2, 4, 64, 64, 64,
                         "key_pad", False)
    if deny == "deny_list":
        monkeypatch.setenv("PT_KERNEL_DENY", "other,flash_attention")
    else:
        set_flags({"FLAGS_use_custom_kernels": False})
    try:
        kreg.reset_counts()
        kreg.reset_stats()
        out, lse = pfa.fused_attention_forward(q, k, v, b, 0.125, True,
                                               "bshd", return_lse=True)
        grads = pfa.fused_attention_backward(q, k, v, b, out, lse, out,
                                             0.125, True, "bshd")
        torch.cuda.synchronize()
        assert not any(kreg.launches().values())
        assert kreg.dispatch_stats()["per_kernel"] == {
            "flash_attention": {"denied": 2}}
    finally:
        set_flags({"FLAGS_use_custom_kernels": True})
    ref = pfa.fused_attention_plain(q, k, v, b, 0.125, True, "bshd",
                                    return_lse=True)
    assert torch.equal(out, ref[0]) and torch.equal(lse, ref[1])
    plain = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, out,
                                               0.125, True, "bshd")
    for g, r in zip(grads[:3], plain[:3]):
        assert torch.equal(g, r)
    kreg.reset_stats()


_WIDE_D_CASES = [
    # (layout, B, H, Sq, Sk, D, bias, causal)
    ("bshd", 2, 4, 128, 128, 192, "key_pad", True),
    ("bhsd", 2, 2, 77, 130, 256, "per_head", False),
    ("bshd", 3, 2, 64, 96, 160, "none", True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [None, _DROP[1]], ids=["nodrop", "t230"])
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal", _WIDE_D_CASES)
def test_head_dims_above_128_run_the_cuda_core_kernels_on_card(
        cuda, dtype, dropout, layout, B, H, Sq, Sk, D, bias, causal):
    """Head dims above 128 (160, 192, 256) take the CUDA-core kernels in
    both dtypes (the tensor-core ones stop at 128), forward and backward,
    within F32_TOL / BWD_F32_TOL / BF16_TOL of the plain versions."""
    q, k, v, b = _inputs(cuda, dtype, layout, B, H, Sq, Sk, D, bias, False,
                         seed=21)
    dout = torch.from_numpy(np.random.default_rng(22).standard_normal(
        q.shape).astype(np.float32)).to(cuda, dtype)
    scale = D ** -0.5
    want_dbias = bias == "per_head"
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, scale, causal, layout,
                                           return_lse=True, dropout=dropout)
    got = pfa.fused_attention_backward(q, k, v, b, out, lse, dout, scale,
                                       causal, layout, dropout=dropout,
                                       want_dbias=want_dbias)
    torch.cuda.synchronize()
    counts = kreg.launches()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["flash_attention_fwd_sm90"] == 0
    assert counts["flash_attention_bwd_dq_sm90"] == 0
    assert counts["flash_attention_bwd_dkv_sm90"] == 0
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, scale, causal,
                                             layout, return_lse=True,
                                             dropout=dropout)
    tol = _tol(dtype, F32_TOL)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)
    exp = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, dout,
                                             scale, causal, layout,
                                             dropout=dropout,
                                             want_dbias=want_dbias)
    tol = _tol(dtype, BWD_F32_TOL)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, exp):
        if r is None:
            assert g is None, name
            continue
        assert torch.isfinite(g.float()).all(), name
        assert r.abs().max() > 0, name
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol,
                                   msg=name)


_WIDER_D_CASES = [
    # (layout, B, H, Sq, Sk, D, bias, causal)
    ("bshd", 2, 2, 96, 80, 264, "key_pad", True),
    ("bhsd", 2, 2, 77, 130, 320, "per_head", False),
    ("bshd", 2, 2, 64, 64, 512, "key_pad", False),
    ("bhsd", 1, 3, 70, 70, 512, "none", True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dropout", [None, _DROP[1]], ids=["nodrop", "t230"])
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal", _WIDER_D_CASES)
def test_head_dims_above_256_run_the_cuda_core_kernels_on_card(
        cuda, dtype, dropout, layout, B, H, Sq, Sk, D, bias, causal):
    """Head dims 264, 320 and 512 run on the CUDA-core kernels (256-column
    groups of the output a block, 128-column chunks of every operand),
    forward and backward, both layouts, causal or not, within F32_TOL /
    BWD_F32_TOL / BF16_TOL of the plain versions; the bf16 gradients also
    within flash_attention.bf16_backward_bound of the exact ones, as at
    D <= 256."""
    q, k, v, b = _inputs(cuda, dtype, layout, B, H, Sq, Sk, D, bias, False,
                         seed=23)
    dout = torch.from_numpy(np.random.default_rng(24).standard_normal(
        q.shape).astype(np.float32)).to(cuda, dtype)
    scale = D ** -0.5
    want_dbias = bias == "per_head"
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, scale, causal, layout,
                                           return_lse=True, dropout=dropout)
    got = pfa.fused_attention_backward(q, k, v, b, out, lse, dout, scale,
                                       causal, layout, dropout=dropout,
                                       want_dbias=want_dbias)
    torch.cuda.synchronize()
    counts = kreg.launches()
    assert {n: c for n, c in counts.items() if c} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
        "flash_attention_bwd_dkv": 1}
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, scale, causal,
                                             layout, return_lse=True,
                                             dropout=dropout)
    tol = _tol(dtype, F32_TOL)
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=tol, atol=tol)
    exp = pfa.fused_attention_backward_plain(q, k, v, b, out, lse, dout,
                                             scale, causal, layout,
                                             dropout=dropout,
                                             want_dbias=want_dbias)
    tol = _tol(dtype, BWD_F32_TOL)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, exp):
        if r is None:
            assert g is None, name
            continue
        assert torch.isfinite(g.float()).all(), name
        assert r.abs().max() > 0, name
        torch.testing.assert_close(g.float(), r.float(), rtol=tol, atol=tol,
                                   msg=name)
    if dtype == torch.bfloat16:
        _assert_within_bound(got[:3], q, k, v, b, out, lse, dout, scale,
                             causal, layout, dropout)


# the float32 tensor-core forward: chip_smoke.py's tensor-core cases (all
# of them meet TMA's rules in float32 too), D = 40 and 36 (rows of 16-byte
# multiples in float32), rows whose keys are all padded, Sq and Sk off
# multiples of 64
_F32_SM90_CASES = _SM90_CASES + [
    ("bshd", 3, 2, 77, 77, 40, "none", True, False),
    ("bhsd", 2, 3, 33, 100, 36, "key_pad", False, True),
    ("bshd", 2, 2, 130, 61, 128, "per_head", True, False),
]


@pytest.mark.parametrize("dropout", _DROP, ids=_DROP_IDS)
@pytest.mark.parametrize("layout,B,H,Sq,Sk,D,bias,causal,pad_all",
                         _F32_SM90_CASES)
def test_f32_tensor_core_forward_matches_plain_on_card(
        cuda, dropout, layout, B, H, Sq, Sk, D, bias, causal, pad_all):
    """The 3xTF32 forward (wgmma tf32, each operand split into hi and
    lo) within F32_TOL of the plain float32 version, out and lse."""
    q, k, v, b = _inputs(cuda, torch.float32, layout, B, H, Sq, Sk, D, bias,
                         pad_all, seed=4)
    assert pfa._sm90_eligible(q, k, v, q, layout)
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, D ** -0.5, causal,
                                           layout, return_lse=True,
                                           dropout=dropout)
    torch.cuda.synchronize()
    assert {n: c for n, c in kreg.launches().items() if c} == {
        "flash_attention_fwd": 1, "flash_attention_fwd_f32_sm90": 1}
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, D ** -0.5, causal,
                                             layout, return_lse=True,
                                             dropout=dropout)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("D", [30, 64])
def test_f32_off_tma_rules_takes_the_cuda_core_forward_on_card(cuda, D):
    """D = 30 (rows of 120 bytes) and q starting 4 bytes past a 16-byte
    boundary: the CUDA-core forward, within F32_TOL."""
    B, S, H = 2, 96, 4
    q, k, v, b = _inputs(cuda, torch.float32, "bshd", B, H, S, S, D,
                         "key_pad", False, seed=6)
    if D == 64:
        base = torch.empty(q.numel() + 1, device=cuda)
        base[1:].copy_(q.reshape(-1))
        q = base[1:].view(q.shape)
        assert q.data_ptr() % 16 == 4
    assert not pfa._sm90_eligible(q, k, v, k, "bshd")
    kreg.reset_counts()
    out, lse = pfa.fused_attention_forward(q, k, v, b, D ** -0.5, False,
                                           "bshd", return_lse=True)
    torch.cuda.synchronize()
    assert {n: c for n, c in kreg.launches().items() if c} == {
        "flash_attention_fwd": 1}
    ref, ref_lse = pfa.fused_attention_plain(q, k, v, b, D ** -0.5, False,
                                             "bshd", return_lse=True)
    torch.testing.assert_close(out, ref, rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(lse, ref_lse, rtol=F32_TOL, atol=F32_TOL)


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


@pytest.mark.parametrize("n", [1, 127, 129, 513, 25000])
def test_sgd_matches_plain_on_card(cuda, n):
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    p, g = (torch.randn(n, device=cuda, generator=gen) for _ in range(2))
    lr = torch.tensor([0.05], device=cuda)
    for wd in (0.0, 1e-4):
        ref = fo.sgd_plain(p.clone(), g, lr[0], wd)
        kreg.reset_counts()
        got = fo.fused_sgd(p, g, lr, weight_decay=wd)
        torch.cuda.synchronize()
        assert kreg.launches()["fused_sgd"] == 1
        assert got is p                                   # in place
        assert int(_ulps(got, ref).max()) == 0, wd
        p = ref


def _sgd_lists(dev, sizes, seed):
    """Parameters and gradients of the given lengths, each a view that
    starts 0-3 floats past a 16-byte boundary, p and g apart."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ps, gs = [], []
    for i, n in enumerate(sizes):
        op, og = i % 4, (i // 4) % 4
        ps.append(torch.randn(n + 4, device=dev, generator=gen)[op:op + n])
        gs.append(torch.randn(n + 4, device=dev, generator=gen)[og:og + n])
    return ps, gs


@pytest.mark.parametrize("sizes,launches", [
    ([1, 3, 4096, 4097, 130000, 16, 0, 5, 70000, 25000, 500, 8], 1),
    ([(i * 37) % 300 + 1 for i in range(2500)], 3)], ids=["mixed", "2500"])
def test_sgd_list_matches_plain_on_card(cuda, sizes, launches):
    """One multi-tensor launch over a list of tensors of mixed lengths
    (an empty one too), misaligned views among them (float4 where p and
    g share their offset, else element by element), and a list of 2500
    that needs three launches (1024 tensors a launch): 0 ulp from
    sgd_plain, with and without weight decay, in place."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    ps, gs = _sgd_lists(cuda, sizes, len(sizes))
    assert {p.data_ptr() % 16 for p in ps} == {0, 4, 8, 12}
    lr = torch.tensor([0.05], device=cuda)
    for wd in (0.0, 1e-4):
        ref = [fo.sgd_plain(p.clone(), g, lr[0], wd) for p, g in zip(ps, gs)]
        kreg.reset_counts()
        got = fo.fused_sgd_multi(ps, gs, lr, weight_decay=wd)
        torch.cuda.synchronize()
        assert kreg.launches()["fused_sgd"] == launches
        for a, p, r in zip(got, ps, ref):
            assert a is p                                  # in place
            assert p.numel() == 0 or int(_ulps(a, r).max()) == 0, wd


def _adam_lists(dev, sizes, seed):
    """Per tensor (p, g, m, v) of the given lengths, each a view that
    starts 0-3 floats past a 16-byte boundary (p, g, m and v apart in
    turns), and each tensor's beta powers (steps 1 to 8)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state, b1ps, b2ps = [], [], []
    for i, n in enumerate(sizes):
        offs = [0, 0, 0, 0]
        offs[i % 4] = (i // 4 + 1) % 4
        ts = []
        for j, o in enumerate(offs):     # p, g, m, v (v >= 0)
            t = torch.randn(n + 4, device=dev, generator=gen)
            t = t * 0.1 if j == 2 else (t * 0.01).abs() if j == 3 else t
            ts.append(t[o:o + n])
        state.append(ts)
        step = i % 8 + 1
        b1ps.append(torch.tensor([0.9 ** step], device=dev))
        b2ps.append(torch.tensor([0.999 ** step], device=dev))
    return state, b1ps, b2ps


@pytest.mark.parametrize("sizes,launches", [
    ([1, 3, 4096, 4097, 130000, 16, 0, 5, 65537, 25000, 500, 8], 1),
    ([(i * 37) % 300 + 1 for i in range(1100)], 3)], ids=["mixed", "1100"])
def test_adam_list_matches_plain_on_card(cuda, sizes, launches):
    """One multi-tensor Adam launch over a list of tensors of mixed
    lengths (an empty one too), misaligned views among them (float4 where
    p, g, m and v share their offset, else element by element), and a
    list of 1100 that needs three launches (512 tensors a launch): three
    consecutive steps, with and without weight decay, 0 ulp from the
    plain version in p, m, v and the beta powers, p, m and v in place."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    lr = torch.tensor([2e-4], device=cuda)
    for wd in (0.0, 0.01):
        state, b1ps, b2ps = _adam_lists(cuda, sizes, len(sizes))
        assert {t.data_ptr() % 16 for ts in state for t in ts} == \
            {0, 4, 8, 12}
        ps, gs, ms, vs = (list(col) for col in zip(*state))
        rp, rm, rv = ([t.clone() for t in col] for col in (ps, ms, vs))
        b1, b2, r1, r2 = b1ps, b2ps, b1ps, b2ps
        for step in range(3):
            ref = fo.adam_multi_plain(rp, gs, rm, rv, lr, r1, r2, 0.9,
                                      0.999, 1e-8, wd)
            kreg.reset_counts()
            got = fo.fused_adam_multi(ps, gs, ms, vs, lr, b1, b2, 0.9,
                                      0.999, 1e-8, wd)
            torch.cuda.synchronize()
            assert kreg.launches()["fused_adam"] == launches
            for a, t in zip(got[0] + got[1] + got[2], ps + ms + vs):
                assert a is t                              # in place
            for name, a, r in zip(("p", "m", "v", "b1p", "b2p"), got, ref):
                for x, y in zip(a, r):
                    assert x.shape == y.shape, name
                    assert x.numel() == 0 or \
                        int(_ulps(x, y).max()) == ADAM_ULP == 0, \
                        (name, step, wd)
            rp, rm, rv, r1, r2 = ref
            b1, b2 = got[3], got[4]


def test_adam_launch_refuses_bad_operands_on_card(cuda):
    """A CUDA tensor of the wrong dtype, lists of different lengths, or a
    beta power of two elements raise; nothing falls back to the plain
    version."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    p = torch.zeros(8, device=cuda)
    one = torch.ones(1, device=cuda)
    lr = torch.tensor([1e-3], device=cuda)
    kreg.reset_counts()
    with pytest.raises(TypeError, match="g must be float32"):
        fo.fused_adam_multi([p], [p.double()], [p], [p], lr, [one], [one])
    with pytest.raises(ValueError, match="lists of 1 parameters"):
        fo.fused_adam_multi([p], [p, p], [p], [p], lr, [one], [one])
    with pytest.raises(TypeError, match="Beta1Pow must be one float32"):
        fo.fused_adam_multi([p], [p], [p], [p], lr,
                            [torch.ones(2, device=cuda)], [one])
    with pytest.raises(TypeError, match="Beta2Pow must be one float32"):
        fo.fused_adam_multi([p], [p], [p], [p], lr, [one], [one.cpu()])
    with pytest.raises(ValueError, match="contiguous"):
        fo.fused_adam(torch.zeros(8, 2, device=cuda).t(),
                      torch.zeros(2, 8, device=cuda),
                      torch.zeros(2, 8, device=cuda),
                      torch.zeros(2, 8, device=cuda), lr)
    assert kreg.launches()["fused_adam"] == 0


def test_dropout_residual_tile_refuses_bad_operands_on_card(cuda):
    """The tensor-core dropout_residual tile raises on a mask of another
    dtype or a residual off a 16-byte boundary; it launches nothing and
    falls back to nothing."""
    from paddle_tpu_torch.tuning import variants as V
    d = V._problem(256, 256, 128, cuda)
    v = V.Variant(128, 128, 32, "dropout_residual")
    assert v.sm90 and v.kernel == "tuned_matmul_dr_sm90"
    kreg.reset_counts()
    with pytest.raises(TypeError, match="float32"):
        V.tuned_matmul(d["x"], d["y"], variant=v, mask=d["mask"].double(),
                       residual=d["residual"])
    res = torch.empty(256 * 256 + 1, device=cuda)[1:].view(256, 256)
    res.copy_(d["residual"])
    with pytest.raises(ValueError, match="16-byte aligned"):
        V.tuned_matmul(d["x"], d["y"], variant=v, mask=d["mask"],
                       residual=res)
    assert not any(kreg.launches().values())


def _lenet_losses(cuda, monkeypatch, floor, steps=3):
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", floor)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = pt.models.lenet_train()
        pt.optimizer.SGD(learning_rate=0.05).minimize(cost)
    main.random_seed = startup.random_seed = 7
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    r = np.random.RandomState(0)
    feed = {"img": r.rand(64, 1, 28, 28).astype(np.float32),
            "label": r.randint(0, 10, (64, 1)).astype(np.int64)}
    kreg.reset_counts()
    losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                            scope=scope)[0]) for _ in range(steps)]
    params = {p.name: np.asarray(scope.find_var(p.name).get_tensor())
              for p in main.all_parameters()}
    return losses, params, kreg.launches()["fused_sgd"]


def test_lenet_sgd_kernel_equals_plain_update_on_card(cuda, monkeypatch):
    """LeNet's SGD step with every update in the kernel (floor 1) and
    with every update plain (floor 65536), from the same startup state:
    equal losses and parameters (cuDNN in deterministic mode)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    plain = _lenet_losses(cuda, monkeypatch, "65536")
    kernel = _lenet_losses(cuda, monkeypatch, "1")
    # the engine hands the step's six sgd ops to one multi-tensor launch
    assert plain[2] == 0 and kernel[2] == 3 * 1
    assert kernel[0] == plain[0]
    for n in plain[1]:
        assert np.array_equal(kernel[1][n], plain[1][n]), n


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


def test_tiny_transformer_training_on_card_matches_cpu(cuda, monkeypatch):
    """Three Adam steps of the tiny Transformer (float32, dropout 0) on
    the card against the same Program on the CPU, from the same
    parameters: losses and every parameter and moment within 1e-4. The
    size floor is 1, so every parameter's update goes through the Adam
    kernel."""
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
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
    # the engine hands the step's adam ops to one multi-tensor launch
    assert counts["fused_adam"] == 3 * 1
    for n in persist:
        np.testing.assert_allclose(
            np.asarray(gpu_scope.find_var(n).get_tensor()),
            np.asarray(cpu_scope.find_var(n).get_tensor()),
            rtol=1e-4, atol=1e-4, err_msg=n)


def _rel(got, ref):
    return ((got.double() - ref.double()).norm() / ref.double().norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 384, 128), (384, 256, 512)])
def test_quantized_matmul_matches_plain_on_card(cuda, M, K, N, dtype):
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(
        cuda, dtype)
    y = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(
        cuda, dtype)
    x[1] *= 40.0                     # one row that sets its tiles' scales
    for mode in ("int8", "bf16"):
        kreg.reset_counts()
        got = qm.quantized_matmul(x, y, mode=mode)
        torch.cuda.synchronize()
        assert kreg.launches()[f"quantized_matmul_{mode}"] == 1
        ref = qm.quantized_matmul_plain(x, y, mode)
        assert got.dtype == torch.float32 and got.shape == (M, N)
        if mode == "int8":
            assert torch.equal(got, ref)
        else:
            assert _rel(got, ref) <= GEMM_RTOL
    with pytest.raises(ValueError, match="contiguous"):
        qm.quantized_matmul(x.t().contiguous().t(), y, mode="int8")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_matmul_misaligned_x_on_card(cuda, dtype):
    """An x that starts 4 bytes past a 16-byte boundary cannot be read by
    TMA: bf16 mode rounds it into the workspace first, int8 packs it as
    always; both still match their plain versions (int8 bit for bit)."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    M, K, N = 256, 256, 384
    rng = np.random.default_rng(31)
    base = torch.from_numpy(rng.standard_normal(M * K + 8).astype(
        np.float32)).to(cuda, dtype)
    x = base[2:2 + M * K].view(M, K)     # 4 or 8 bytes past the base
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    y = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(
        cuda, dtype)
    for mode in ("int8", "bf16"):
        kreg.reset_counts()
        got = qm.quantized_matmul(x, y, mode=mode)
        torch.cuda.synchronize()
        assert kreg.launches()[f"quantized_matmul_{mode}"] == 1
        ref = qm.quantized_matmul_plain(x, y, mode)
        if mode == "int8":
            assert torch.equal(got, ref)
        else:
            assert _rel(got, ref) <= GEMM_RTOL


@pytest.mark.parametrize("M,K,N", [(8192, 512, 512), (1024, 2048, 512),
                                   (2048, 512, 2048)])
def test_quantized_matmul_serving_shapes_on_card(cuda, M, K, N):
    """The serving forward's GEMM shapes (M cut where the plain int8
    version's memory would not matter): int8 bit-equal, bf16 within
    GEMM_RTOL, float32 operands as the forward gives them."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    rng = np.random.default_rng(M + 3 * K + N)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(cuda)
    x[::97] *= 30.0
    y = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(cuda) \
        * K ** -0.5
    for mode in ("int8", "bf16"):
        got = qm.quantized_matmul(x, y, mode=mode)
        ref = qm.quantized_matmul_plain(x, y, mode)
        torch.cuda.synchronize()
        if mode == "int8":
            assert torch.equal(got, ref)
        else:
            assert _rel(got, ref) <= GEMM_RTOL


def test_every_tuned_variant_matches_plain_on_card(cuda):
    """Every instantiated tile of both designs (tuned_matmul.cu on the
    CUDA cores, tuned_matmul_sm90.cu in 3xTF32 on the tensor cores)
    within GEMM_RTOL of the plain version, one launch of its own kernel
    counter and none of another."""
    from paddle_tpu_torch.tuning import variants as V
    built = V.instantiated_variants()
    assert sorted(built) == sorted(
        (b[0], b[1], b[2], ep) for ep in ("none", "layer_norm",
                                          "dropout_residual")
        for b in V._BLOCKS[ep])
    assert {v.kernel for v in V.enumerate_variants(256, 512, 128)} == {
        "tuned_matmul", "tuned_matmul_ln", "tuned_matmul_dr",
        "tuned_matmul_sm90", "tuned_matmul_ln_sm90", "tuned_matmul_dr_sm90"}
    for N in (256, 512):
        d = V._problem(256, N, 128, cuda)
        for v in V.enumerate_variants(256, N, 128):
            kreg.reset_counts()
            got = V._run_variant(v, d)
            torch.cuda.synchronize()
            assert {n: c for n, c in kreg.launches().items() if c} == {
                v.kernel: 1}, v.label
            with kreg.plain_reference():
                ref = V._run_variant(v, d)
            assert _rel(got, ref) <= GEMM_RTOL, v.label


@pytest.mark.parametrize("M,K,N", [(8192, 512, 512), (8192, 512, 2048),
                                   (8192, 2048, 512), (8192, 512, 32000)])
def test_tensor_core_tuned_tiles_at_serving_shapes_on_card(cuda, M, K, N):
    """The tensor-core tiles at the serving forward's four GEMM shapes
    (float32 operands as the forward gives them, every 97th row of x 30x
    larger) within GEMM_RTOL of the plain version: none and
    dropout_residual at every shape, the layer_norm tile where N is its
    bn."""
    from paddle_tpu_torch.tuning import variants as V
    rng = np.random.default_rng(M + 3 * K + N)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(cuda)
    x[::97] *= 30.0
    y = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(cuda) \
        * K ** -0.5
    e = {"gamma": torch.from_numpy(
             1 + 0.1 * rng.standard_normal(N, np.float32)).to(cuda),
         "beta": torch.from_numpy(
             0.1 * rng.standard_normal(N, np.float32)).to(cuda),
         "mask": torch.from_numpy(
             (rng.random((M, N)) < 0.9).astype(np.float32)).to(cuda),
         "residual": torch.from_numpy(
             rng.standard_normal((M, N), np.float32)).to(cuda)}
    tiles = [v for v in V.enumerate_variants(M, N, K) if v.sm90]
    assert {v.epilogue for v in tiles} == (
        {"none", "layer_norm", "dropout_residual"} if N == 512
        else {"none", "dropout_residual"})
    for v in tiles:
        kw = V._kwargs(v, e)
        kreg.reset_counts()
        got = V.tuned_matmul(x, y, variant=v, **kw)
        ref = V.tuned_matmul_plain(x, y, variant=v, **kw)
        torch.cuda.synchronize()
        assert {n: c for n, c in kreg.launches().items() if c} == {
            v.kernel: 1}, v.label
        assert torch.isfinite(got).all(), v.label
        assert _rel(got, ref) <= GEMM_RTOL, v.label
        del got, ref


def test_tensor_core_round_probe_on_card(cuda):
    """The probe of how the tensor cores round a float32 sum (one tf32
    wgmma adding 0.625 of the last place to +-1) reads one mode in every
    element: +-(1 + 2^-23) to nearest, +-1 toward zero; the sign follows
    the column."""
    from paddle_tpu_torch.tuning import variants as V
    out = V.round_probe(cuda).cpu()
    sign = torch.where(torch.arange(64) % 2 == 1, -1.0, 1.0)[None, :]
    mags = (out * sign)
    assert (mags > 0).all()
    assert (mags == 1).all() or (mags == 1 + 2.0 ** -23).all()


def test_search_and_winner_route_mul_on_card(cuda):
    from paddle_tpu_torch.tuning import variants as V
    res = V.search_variants(256, 256, 256, iters=2, device=cuda)
    assert res["timed"] and all(r["ms"] > 0 for r in res["admitted"])
    assert set(res["winners"]) == {"none", "layer_norm",
                                   "dropout_residual"}
    try:
        assert V.register_winner(res["winners"]) == "tuned_matmul"
        rng = np.random.default_rng(5)
        x = rng.standard_normal((512, 256), np.float32)
        w = rng.standard_normal((256, 256), np.float32)
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            a = pt.layers.data(name="a", shape=[512, 256], dtype="float32",
                               append_batch_size=False)
            b = pt.layers.data(name="b", shape=[256, 256], dtype="float32",
                               append_batch_size=False)
            out = pt.layers.matmul(a, b)
        kreg.reset_counts()
        got, = pt.Executor().run(main, feed={"a": x, "b": w},
                                 fetch_list=[out], scope=pt.Scope())
        w0 = res["winners"]["none"]
        kern = V.Variant(w0["bm"], w0["bn"], w0["bk"], "none").kernel
        assert kreg.launches()[kern] == 1
        np.testing.assert_allclose(got, x @ w, rtol=1e-4, atol=1e-4)
    finally:
        kreg.unregister_kernel("tuned_matmul")


def test_tiny_transformer_int8_on_card_matches_cpu(cuda, monkeypatch):
    """int8 mode: the card's kernels against the plain versions on the
    CPU. Not bit-equal as a whole: a last-bit difference upstream (the
    attention kernel's float32 sums) can move a value across a rounding
    boundary of the next quantization."""
    cfg = T.transformer_base(src_vocab_size=256, trg_vocab_size=256,
                             fuse_attention=True)
    cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 128, 256
    cfg.n_head, cfg.d_head = 4, 32
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, logits, _ = T.transformer_train(cfg, is_test=True)
    cpu_scope = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=cpu_scope)
    gpu_scope = pt.Scope()
    load_params_from_numpy(
        gpu_scope, {p.name: np.asarray(cpu_scope.find_var(p.name)
                                       .get_tensor())
                    for p in main.all_parameters()}, pt.CUDAPlace(0))
    feed = T.make_batch(cfg, 4, 32, 32, rng=np.random.default_rng(1),
                        src_lens=np.array([32, 20, 27, 9]),
                        trg_lens=np.array([32, 31, 12, 25]))
    monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", "int8")
    monkeypatch.setattr(kreg, "_ROUTE_ON_CPU", True)
    lc, cc = pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=[logits, cost], scope=cpu_scope)
    n_mul = sum(op.type == "mul" for op in main.global_block().ops)
    kreg.reset_counts()
    lg, cg = pt.Executor().run(main, feed=feed, fetch_list=[logits, cost],
                               scope=gpu_scope)
    assert kreg.launches()["quantized_matmul_int8"] == n_mul
    rel = np.linalg.norm(lg - lc) / np.linalg.norm(lc)
    assert rel <= 1e-3 and abs(float(cg) - float(cc)) <= 1e-3


def test_resnet50_amp_step_on_card(cuda):
    """One step of bench.py's ResNet-50 program (depth 50, 224x224,
    Momentum(0.1, 0.9) under decorate) at B=8 on the card: a finite
    loss, the running statistics of every batch norm moved, and none of
    the port's kernels launched (no attention; the one mul runs
    cuBLAS)."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = pt.models.resnet_train(depth=50)
        pt.contrib.mixed_precision.decorate(
            pt.optimizer.MomentumOptimizer(0.1, 0.9)).minimize(cost)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    stats = [v.name for v in main.global_block().vars.values()
             if v.name.endswith((".bn.mean", ".bn.var"))]
    before = {n: scope.find_var(n).get_tensor().tensor.clone()
              for n in stats}
    r = np.random.RandomState(0)
    feed = {"image": r.rand(8, 3, 224, 224).astype(np.float32),
            "label": r.randint(0, 1000, (8, 1)).astype(np.int64)}
    kreg.reset_counts()
    loss, = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    assert np.isfinite(loss).all()
    assert not any(kreg.launches().values())
    assert len(stats) == 2 * 53
    for n in stats:
        after = scope.find_var(n).get_tensor().tensor
        assert after.dtype == torch.float32 and after.is_cuda, n
        assert not torch.equal(after, before[n]), n


def _cache_steps(main, startup, cost, feed, cached):
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    losses = [exe.run(main, feed=feed, fetch_list=[cost], scope=scope,
                      use_program_cache=cached)[0] for _ in range(3)]
    state = {v.name: scope.find_var(v.name).get_tensor().tensor.clone()
             for v in main.global_block().vars.values()
             if v.persistable and scope.find_var(v.name) is not None}
    return losses, state, exe._engine.counters["fast_path_hits"]


@pytest.mark.parametrize("model", ["lenet", "transformer"])
def test_plan_cache_steps_bit_equal_on_card(cuda, monkeypatch, model):
    """3 training steps with the engine's plan cache and without it
    (use_program_cache=False) from the same startup state: bit-equal
    losses and persistables, in deterministic mode (cuDNN's
    deterministic algorithms; torch's deterministic index_add_ for the
    embedding gradients)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        if model == "lenet":
            cost, _, _ = pt.models.lenet_train()
            pt.optimizer.SGD(learning_rate=0.05).minimize(cost)
            r = np.random.RandomState(0)
            feed = {"img": r.rand(64, 1, 28, 28).astype(np.float32),
                    "label": r.randint(0, 10, (64, 1)).astype(np.int64)}
        else:
            cfg = T.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                                     fuse_attention=True, dropout=0.1)
            cfg.n_layer, cfg.d_model, cfg.d_inner = 1, 32, 64
            cfg.n_head, cfg.d_head = 4, 8
            cost, _, _ = T.transformer_train(cfg)
            pt.contrib.mixed_precision.decorate(
                pt.optimizer.AdamOptimizer(learning_rate=2e-3)).minimize(
                    cost)
            feed = T.make_batch(cfg, 4, 16, 12,
                                rng=np.random.default_rng(3),
                                src_lens=np.array([16, 11, 7, 13]),
                                trg_lens=np.array([12, 9, 5, 12]))
    main.random_seed = startup.random_seed = 5
    try:
        la, sa, hits_a = _cache_steps(main, startup, cost, feed, True)
        lb, sb, hits_b = _cache_steps(main, startup, cost, feed, False)
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    assert (hits_a, hits_b) == (2, 0)
    assert all(np.array_equal(a, b) for a, b in zip(la, lb))
    assert sa.keys() == sb.keys()
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


# ---------------------------------------------------------------------------
# SelectedRows: the sparse updates and Wide&Deep
# ---------------------------------------------------------------------------

class _OptOp:
    """An optimizer op's view: slot -> the slot's name in lower case."""

    def __init__(self, type, inputs, outputs, attrs):
        self.type = type
        self._inputs = {s: [s.lower()] for s in inputs}
        self._outputs = {s: [s[:-3].lower()] for s in outputs}
        self._attrs = attrs

    def input(self, slot):
        return self._inputs.get(slot, [])

    def output(self, slot):
        return self._outputs.get(slot, [])

    def input_slots(self):
        return list(self._inputs)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


_SPARSE_OPTS = {
    "sgd": ({}, []),
    "momentum": ({"mu": 0.9, "use_nesterov": False}, ["Velocity"]),
    "momentum_nesterov": ({"mu": 0.9, "use_nesterov": True}, ["Velocity"]),
    "adagrad": ({"epsilon": 1e-6}, ["Moment"]),
    "adam": ({"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             ["Moment1", "Moment2", "Beta1Pow", "Beta2Pow"]),
}


def _sparse_update(name, dev, height, rows, values, seed=0):
    """One sparse update of optimizer `name` on `dev` from seeded state;
    the card's runs under sync debug mode "error". Returns the state
    before and after, on the CPU."""
    from paddle_tpu_torch.core.registry import ExecContext, OPS
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    attrs, state = _SPARSE_OPTS[name]
    rng = np.random.default_rng(seed)
    d = values.shape[1]
    ins = {"Param": rng.standard_normal((height, d)).astype(np.float32),
           "LearningRate": np.array([0.05], np.float32)}
    for s in state:
        ins[s] = np.array([0.9 ** 3 if s == "Beta1Pow" else 0.999 ** 3],
                          np.float32) if s.endswith("Pow") \
            else np.abs(rng.standard_normal((height, d))).astype(np.float32)
    outs = [s + "Out" for s in ins if s != "LearningRate"]
    op = _OptOp(name.split("_")[0], list(ins) + ["Grad"], outs, attrs)
    env = {s.lower(): torch.from_numpy(a.copy()).to(dev)
           for s, a in ins.items()}
    env["grad"] = SelectedRows(torch.from_numpy(rows).to(dev),
                               torch.from_numpy(values).to(dev), height)
    before = {k: v.cpu().clone() for k, v in env.items() if k != "grad"}
    lowering = OPS.get(op.type).lowering
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("error")
        try:
            lowering(ExecContext(op, env, dev))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()            # a device assert raises here
    else:
        lowering(ExecContext(op, env, dev))
    return before, {k: v.cpu() for k, v in env.items() if k != "grad"}


def _sparse_grad(height, n, d, seed, padding_idx=None, all_parked=False,
                 heavy=False):
    """rows and values of a sparse gradient: n slots over the first
    height - 10 rows (rows height-10.. never looked up), padding_idx
    slots parked at height; heavy: a quarter of the slots on one row."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, height - 10, n)
    if heavy:
        rows[: n // 4] = rows[n // 4]
    if padding_idx is not None:
        rows[rng.random(n) < 0.2] = padding_idx
        rows = np.where(rows == padding_idx, height, rows)
    if all_parked:
        rows[:] = height
    return rows.astype(np.int64), rng.standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(_SPARSE_OPTS))
@pytest.mark.parametrize("height,n", [
    (12, 20),                     # every row looked up ~8 times
    (1000001, 106496)])           # the CTR batch's ids into its table
def test_sparse_update_matches_cpu_on_card(cuda, name, height, n):
    rows, values = _sparse_grad(height, n, 16, seed=height,
                                padding_idx=3)
    _, want = _sparse_update(name, torch.device("cpu"), height, rows,
                             values)
    before, got = _sparse_update(name, cuda, height, rows, values)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=SPARSE_TOL, atol=SPARSE_TOL,
                                   err_msg=k)
        if got[k].shape[0] == height:
            # the padding row and the rows never looked up: untouched
            for r in [3] + list(range(height - 10, height)):
                assert torch.equal(got[k][r], before[k][r]), (k, r)


def _sum_bound(rows, mags, height):
    """Per row, 2 k 2^-24 times the sum of the magnitudes added into it
    (k of them): how far two orders of a float32 sum can part."""
    k = np.bincount(rows, minlength=height + 1)[:height, None]
    total = np.zeros((height, mags.shape[1]))
    live = rows < height
    np.add.at(total, rows[live], mags[live])
    return 2.0 * k * 2.0 ** -24 * total


@pytest.mark.parametrize("name", sorted(_SPARSE_OPTS))
def test_heavy_duplicates_on_card(cuda, name):
    """A quarter of 8192 slots on one row of 50000: the card's merge
    against the CPU's within the summation bound; sgd (no merge) within
    it over the parameter; the merged update from the CPU's merged
    gradient within SPARSE_TOL."""
    from paddle_tpu_torch.core.selected_rows import merge_rows
    height = 50000
    rows, values = _sparse_grad(height, 8192, 16, seed=5, padding_idx=3,
                                heavy=True)
    r, v = merge_rows(torch.from_numpy(rows), torch.from_numpy(values),
                      height)
    rc, vc = merge_rows(torch.from_numpy(rows).to(cuda),
                        torch.from_numpy(values).to(cuda), height)
    assert torch.equal(rc.cpu(), r)
    live = (r < height).numpy()
    bound = _sum_bound(rows, np.abs(values), height)[r.numpy()[live]]
    assert (np.abs(vc.cpu().numpy()[live] - v.numpy()[live])
            <= bound + SPARSE_TOL).all()
    if name == "sgd":
        before, got = _sparse_update(name, cuda, height, rows, values)
        _, want = _sparse_update(name, torch.device("cpu"), height, rows,
                                 values)
        p0 = before["param"].numpy()
        bound = _sum_bound(rows, 0.05 * np.abs(values), height) + \
            2.0 * np.bincount(rows, minlength=height + 1)[:height, None] \
            * 2.0 ** -24 * np.abs(p0)
        assert (np.abs(got["param"].numpy() - want["param"].numpy())
                <= bound + SPARSE_TOL).all()
        return
    # the merged gradient has no duplicates: its update is order-free
    rows, values = r.numpy(), v.numpy()
    _, want = _sparse_update(name, torch.device("cpu"), height, rows,
                             values)
    _, got = _sparse_update(name, cuda, height, rows, values)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=SPARSE_TOL, atol=SPARSE_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(_SPARSE_OPTS))
def test_all_parked_sparse_update_changes_nothing_on_card(cuda, name):
    rows, values = _sparse_grad(1000, 64, 16, seed=1, all_parked=True)
    before, got = _sparse_update(name, cuda, 1000, rows, values)
    for k in got:
        if got[k].shape[0] == 1000:
            assert torch.equal(got[k], before[k]), k


def _wide_deep(is_sparse):
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    L = pt.layers
    with pt.program_guard(main, startup):
        slots = L.data("slot_ids", [-1, 26], append_batch_size=False,
                       dtype="int32")
        dense = L.data("dense_feat", [-1, 13], append_batch_size=False,
                       dtype="float32")
        label = L.data("ctr_label", [-1, 1], append_batch_size=False,
                       dtype="float32")
        logit = pt.models.wide_deep.wide_deep(slots, dense, 1001, 16,
                                              is_sparse=is_sparse)
        cost = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        pt.optimizer.AdagradOptimizer(0.01).minimize(cost)
    main.random_seed = startup.random_seed = 5
    return main, startup, cost


def test_wide_deep_sparse_step_matches_dense_on_card(cuda):
    """3 Adagrad steps of Wide&Deep at vocab 1001, B=64 with is_sparse
    True and False from the same parameters on the card, and the dense
    steps against the same steps on the CPU."""
    r = np.random.RandomState(0)
    feed = {"slot_ids": r.randint(0, 1001, (64, 26)).astype(np.int32),
            "dense_feat": r.rand(64, 13).astype(np.float32),
            "ctr_label": r.randint(0, 2, (64, 1)).astype(np.float32)}
    main, startup, _ = _wide_deep(False)
    scope0 = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=scope0)
    init = {n: np.asarray(scope0.find_var(n).get_tensor())
            for n in scope0._vars}
    out = {}
    for label, is_sparse, place in (("dense", False, pt.CUDAPlace(0)),
                                    ("sparse", True, pt.CUDAPlace(0)),
                                    ("cpu", False, pt.CPUPlace())):
        main, _, cost = _wide_deep(is_sparse)
        scope = pt.Scope()
        load_params_from_numpy(scope, init, place)
        exe = pt.Executor(place)
        losses = [float(exe.run(main, feed=feed, fetch_list=[cost],
                                scope=scope)[0]) for _ in range(3)]
        out[label] = losses, {n: np.asarray(scope.find_var(n).get_tensor())
                              for n in init}
    for label in ("sparse", "cpu"):
        losses, state = out[label]
        np.testing.assert_allclose(losses, out["dense"][0], rtol=1e-5,
                                   atol=1e-5, err_msg=label)
        for n, d in out["dense"][1].items():
            m = out["dense"][1].get(n + "_moment_0")
            atol = 1e-5 if m is None else \
                np.where(m < CTR_TINY_G ** 2, CTR_TINY_G_ATOL, 1e-5)
            assert (np.abs(state[n] - d) <= atol + 1e-5 * np.abs(d)).all(), \
                (label, n)


# ---------------------------------------------------------------------------
# dygraph.jit.capture: one CUDA graph a signature
# ---------------------------------------------------------------------------

def _dy_conv_net():
    """tests/test_dygraph_capture.py's ConvNet."""
    class ConvNet(pt.dygraph.Layer):
        def __init__(self):
            super().__init__("net")
            self.c1 = pt.dygraph.nn.Conv2D("c1", 8, 3, padding=1)
            self.c2 = pt.dygraph.nn.Conv2D("c2", 16, 3, padding=1, stride=2)
            self.fc = pt.dygraph.nn.FC("fc", 10)

        def forward(self, x):
            h = pt.layers.relu(self.c1(x))
            return self.fc(pt.layers.relu(self.c2(h)))
    return ConvNet()


def _dy_step(model, opt, extra=None):
    def step(x, y):
        logits = model(x)
        loss = pt.layers.mean(
            pt.layers.softmax_with_cross_entropy(logits, y))
        if extra is not None:
            extra(loss)
        loss.backward()
        opt.minimize(loss)
        model.clear_gradients()
        return loss
    return step


def _dy_data(dev, n=16):
    r = np.random.RandomState(0)
    return (torch.from_numpy(r.rand(n, 1, 28, 28).astype(np.float32)).to(dev),
            torch.from_numpy(r.randint(0, 10, (n, 1))).to(dev))


def test_dygraph_capture_is_a_cuda_graph(cuda):
    """Adam through the capture on the card: discovery, one graph a
    signature, every call one replay, and the trajectory of the eager
    steps from the same parameters (deterministic: 0 ulp)."""
    x, y = _dy_data(cuda)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _capture_against_eager(x, y)
    finally:
        torch.backends.cudnn.deterministic = det


def _capture_against_eager(x, y):
    np.random.seed(0)
    with pt.dygraph.guard(pt.CUDAPlace(0)):
        model = _dy_conv_net()
        opt = pt.optimizer.AdamOptimizer(0.01)
        step = _dy_step(model, opt)
        cap = pt.dygraph.jit.capture(step, optimizer=opt)
        tracer = pt.framework._dygraph_tracer()
        cap._discover_state(tracer, [x, y])
        init = {n: vb.value.clone() for n, vb in cap._state.items()}
        lc = [float(cap(x, y).numpy().reshape(())) for _ in range(4)]
        entry, = cap._cache.values()
        assert isinstance(entry.graph, torch.cuda.CUDAGraph)
        assert entry.replays == cap.captured_calls == 4
        assert cap.eager_calls == 1
        after = {n: vb.value.clone() for n, vb in cap._state.items()}
        for n, vb in cap._state.items():
            vb.value = init[n].clone()
        le = [float(step(pt.dygraph.VarBase(x, stop_gradient=True),
                         pt.dygraph.VarBase(y, stop_gradient=True))
                    .numpy().reshape(())) for _ in range(4)]
        assert lc == le and lc[-1] < lc[0]
        for n, vb in cap._state.items():
            assert torch.equal(vb.value, after[n]), n
        # a parameter replaced between calls is read by the next replay
        w = model.fc.parameters()[0]
        w.set_value(np.zeros(w.shape, np.float32))
        cap(x, y)
        assert w.value is cap._static[f"p:{w.name}"]
        assert float(w.value.abs().max()) < 0.1


def test_dygraph_capture_refuses_a_host_sync(cuda):
    x, y = _dy_data(cuda)
    np.random.seed(0)
    with pt.dygraph.guard(pt.CUDAPlace(0)):
        model = _dy_conv_net()
        opt = pt.optimizer.SGDOptimizer(0.1)
        # .item() on the card (discovery's loss is a meta tensor, and
        # the eager warm-up may sync): the capture must refuse it
        cap = pt.dygraph.jit.capture(_dy_step(
            model, opt, extra=lambda loss: loss.value.is_meta or
            loss.value.item()), optimizer=opt)
        with pytest.raises(RuntimeError, match="synchroniz"):
            cap(x, y)
        assert cap.eager_calls == 1 and cap.captured_calls == 0
        # the state is the discovered one, on the card, not a graph's
        for n, vb in cap._state.items():
            assert vb.value.device.type == "cuda" and vb.grad is None, n
        assert torch.cuda.get_sync_debug_mode() == 0


def test_dygraph_captured_dropout_draws_anew_or_raises(cuda):
    """A captured Dropout must not replay one mask: each replay draws a
    new one from the tracer's generator registered with the graph, or
    the capture raises where torch cannot register it."""
    x = torch.ones(64, 64, device=cuda)
    np.random.seed(0)
    with pt.dygraph.guard(pt.CUDAPlace(0)):
        drop = pt.dygraph.nn.Dropout(0.5)
        cap = pt.dygraph.jit.capture(lambda v: drop(v))
        if hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            a, b, c = (cap(x).numpy() for _ in range(3))
            assert not np.array_equal(a, b) and not np.array_equal(b, c)
            assert 0.4 < (a > 0).mean() < 0.6
        else:
            with pytest.raises(RuntimeError, match="random"):
                cap(x)


# ---------------------------------------------------------------------------
# the engine's captured block (core/engine.py _Captured) and the device
# seed of the attention kernels
# ---------------------------------------------------------------------------

def _deterministic(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    return old


def _capture_program(model, monkeypatch):
    """ResNet-50's bottleneck blocks at stages [1, 1, 1, 1] under bf16 AMP
    with Momentum, or the 2+2-layer d_model 64 Transformer with dropout
    0.1 under bf16 AMP with Adam; (main, startup, cost, feed)."""
    from paddle_tpu_torch.models import resnet as R
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        if model == "resnet":
            monkeypatch.setitem(R._DEPTH_CFG, 50,
                                ("bottleneck", [1, 1, 1, 1]))
            cost, _, _ = pt.models.resnet_train(depth=50,
                                                image_shape=(3, 64, 64))
            opt = pt.optimizer.MomentumOptimizer(0.1, 0.9)
            r = np.random.RandomState(0)
            feed = {"image": r.rand(8, 3, 64, 64).astype(np.float32),
                    "label": r.randint(0, 1000, (8, 1)).astype(np.int64)}
        else:
            cfg = T.transformer_base(src_vocab_size=64, trg_vocab_size=64,
                                     fuse_attention=True, dropout=0.1)
            cfg.n_layer, cfg.d_model, cfg.d_inner = 2, 64, 128
            cfg.n_head, cfg.d_head = 4, 16
            cost, _, _ = T.transformer_train(cfg)
            opt = pt.optimizer.AdamOptimizer(learning_rate=2e-3)
            feed = T.make_batch(cfg, 4, 16, 12,
                                rng=np.random.default_rng(3),
                                src_lens=np.array([16, 11, 7, 13]),
                                trg_lens=np.array([12, 9, 5, 12]))
        pt.contrib.mixed_precision.decorate(opt).minimize(cost)
    main.random_seed = startup.random_seed = 5
    return main, startup, cost, feed


@pytest.mark.parametrize("model", ["resnet", "transformer"])
def test_captured_steps_bit_equal_eager_steps_on_card(cuda, monkeypatch,
                                                      model):
    """4 steps with the plan cache (the second run captures the block,
    the others replay it) and 4 with use_program_cache=False, from one
    startup state in deterministic mode: bit-equal losses and
    persistables, dropout masks included; the attention launches counted
    per run under replay."""
    old = _deterministic(monkeypatch)
    main, startup, cost, feed = _capture_program(model, monkeypatch)
    try:
        runs = {}
        for cached in (True, False):
            exe, scope = pt.Executor(), pt.Scope()
            exe.run(startup, scope=scope)
            before = dict(exe._engine.counters)
            losses, counts = [], []
            for _ in range(4):
                kreg.reset_counts()
                losses.append(exe.run(main, feed=feed, fetch_list=[cost],
                                      scope=scope,
                                      use_program_cache=cached)[0])
                counts.append(kreg.launches())
            state = {v.name: scope.find_var(v.name).get_tensor().tensor
                     .clone() for v in main.global_block().vars.values()
                     if v.persistable and scope.find_var(v.name)
                     is not None}
            runs[cached] = (losses, counts, state,
                            {k: v - before[k] for k, v in
                             exe._engine.counters.items()})
            exe.close()
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    (la, ca, sa, na), (lb, cb, sb, nb) = runs[True], runs[False]
    assert (na["captures"], na["replays"], na["eager_runs"]) == (1, 3, 1)
    assert (nb["captures"], nb["replays"], nb["eager_runs"]) == (0, 0, 4)
    assert all(np.array_equal(a, b) for a, b in zip(la, lb))
    assert len({float(x) for x in la}) == 4
    assert ca == cb
    if model == "transformer":
        assert ca[0]["flash_attention_fwd"] == 6 == \
            ca[-1]["flash_attention_bwd_dkv"]
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


@pytest.mark.parametrize("design", ["tensor_core", "cuda_core"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_attention_kernels_read_their_seed_on_the_card(cuda, monkeypatch,
                                                       design, dtype):
    """Forward and backward with the seed as a device tensor: equal to
    the same words as ints bit for bit and to the plain version within
    its tolerance; captured once in a CUDA graph, each replay draws the
    mask of the words written into the tensor before it."""
    if design == "cuda_core":
        monkeypatch.setattr(pfa, "_sm90_eligible", lambda *a: False)
    layout, B, H, S, D = "bshd", 2, 4, 128, 64
    q, k, v, b = _inputs(cuda, dtype, layout, B, H, S, S, D, "key_pad",
                         False)
    g = torch.randn_like(q)
    scale, t = D ** -0.5, 230
    seed = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64,
                        device=cuda)

    def step(drop):
        out, lse = pfa.fused_attention_forward(q, k, v, b, scale, False,
                                               layout, return_lse=True,
                                               dropout=drop)
        grads = pfa.fused_attention_backward(q, k, v, b, out, lse, g,
                                             scale, False, layout,
                                             dropout=drop)
        return (out, lse) + tuple(grads[:3])

    got = step((seed, t))
    host = step((0x12345678, 0x9ABCDEF0, t))
    for a, h in zip(got, host):
        assert torch.equal(a, h)
    with kreg.plain_reference():
        ref = step((seed, t))
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got[0].float(), ref[0].float(), rtol=tol,
                               atol=tol)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step((seed, t))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step((seed, t))
    for words in ((3, 4), (0xFFFFFFFF, 7)):
        seed.copy_(torch.tensor(words, dtype=torch.int64))
        graph.replay()
        want = step((*words, t))
        for a, w in zip(outs, want):
            assert torch.equal(a, w), words


_H2D = "host_copy_for_capture_test"


def test_a_host_sync_in_a_captured_block_raises_on_card(cuda):
    """An op that copies a host value to the card runs on meta, so the
    rule admits its block; the capture (sync debug mode "error") then
    raises: it does not run the block eager."""
    from paddle_tpu_torch.core.registry import OPS, register_op

    @register_op(_H2D)
    def _h2d(ctx):
        x = ctx.input("X")
        ctx.set_output("Out", x + torch.tensor([1.0], device=x.device))
    try:
        _host_copy_block_raises()
    finally:
        for t in (_H2D, _H2D + "_grad"):
            OPS._map.pop(t, None)


def _host_copy_block_raises():
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.layers.data("x", [4], dtype="float32")
        h = pt.layers.fc(x, 4)
        out = main.global_block().create_var(name="shifted",
                                             dtype="float32", shape=h.shape)
        main.global_block().append_op(type=_H2D, inputs={"X": [h.name]},
                                      outputs={"Out": [out.name]},
                                      infer_shape=False)
        cost = pt.layers.mean(out)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    exe.run(main, feed=feed, fetch_list=[cost], scope=scope)   # eager
    with pytest.raises(RuntimeError):
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    assert not exe._engine.eager_reasons
    assert torch.cuda.get_sync_debug_mode() == 0


def test_recapture_after_every_graph_was_released_on_card(cuda):
    """A routing change releases a plan's graph before its next capture,
    which then needs a memory pool of its own (torch frees a pool with
    its last graph): plain_reference() and back capture twice more."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        cost, _, _ = pt.models.lenet_train()
        pt.optimizer.SGD(learning_rate=0.05).minimize(cost)
    r = np.random.RandomState(0)
    feed = {"img": r.rand(16, 1, 28, 28).astype(np.float32),
            "label": r.randint(0, 10, (16, 1)).astype(np.int64)}
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    before = dict(exe._engine.counters)
    for plain in (False, True, False):
        with (kreg.plain_reference() if plain else
              contextlib.nullcontext()):
            for _ in range(2):
                loss, = exe.run(main, feed=feed, fetch_list=[cost],
                                scope=scope)
                assert np.isfinite(loss).all()
    c = {k: v - before[k] for k, v in exe._engine.counters.items()}
    assert (c["captures"], c["replays"], c["eager_runs"]) == (3, 5, 1)
    exe.close()


def _book_lm_on_card(tmp_path, vocab, hidden, layers, buckets):
    """A book LM initialized on the card from the startup program's
    seed, exported, and loaded on the card (warmed up)."""
    from paddle_tpu_torch.inference import serving
    pt.framework.unique_name.reset()
    pre, dec, startup, meta = serving.build_book_lm(
        vocab=vocab, hidden=hidden, num_layers=layers, max_len=64)
    startup.random_seed = 7
    d = str(tmp_path / "book_lm")
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor()
        exe.run(startup)
        serving.export_serving_model(d, exe, pre, dec, meta,
                                     buckets=buckets)
    model = serving.load_serving_model(d)
    assert model.device.type == "cuda"
    return model


_BOOK_PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11, 12, 13, 14]]


def test_serving_burst_replays_and_matches_solo_on_card(cuda, tmp_path):
    """After warmup() every signature is a CUDA graph: a burst plans,
    captures and runs eagerly nothing, and each request's tokens equal
    its solo run (reference_generate) bit for bit, float32."""
    from paddle_tpu_torch.inference import serving
    bk = serving.BucketSpec(batch=3, prefill_lens=(8,),
                            cache_lens=(16, 24))
    model = _book_lm_on_card(tmp_path, 29, 8, 2, bk)
    assert model.warmup() == 3
    c0 = dict(model.engine_counters())
    assert c0["captures"] == 3
    eng = serving.ServingEngine(model)
    reqs = [eng.submit(p, max_new_tokens=12) for p in _BOOK_PROMPTS]
    while eng.pending():
        eng.step()
    c1 = model.engine_counters()
    assert (c1["captures"], c1["eager_runs"], c1["traces"]) == \
        (c0["captures"], c0["eager_runs"], c0["traces"])
    assert c1["replays"] > c0["replays"]
    assert eng.kv.pages_in_use == 0
    for r, p in zip(reqs, _BOOK_PROMPTS):
        assert r.status == serving.STATUS_OK
        assert r.tokens == serving.reference_generate(model, p, 12)
    assert model.engine_counters()["captures"] == c0["captures"]


def test_serving_gemm_kernels_per_dispatch_on_card(cuda, tmp_path,
                                                   monkeypatch):
    """At hidden 128, vocab 256 and batch 128 every fc of a prefill and
    of a decode dispatch (6 a layer and the head) takes the quantized
    GEMM in its mode; bf16 tokens equal the solo run's (each output row
    depends on its own row)."""
    from paddle_tpu_torch.inference import serving
    bk = serving.BucketSpec(batch=128, prefill_lens=(8,),
                            cache_lens=(16,))
    model = _book_lm_on_card(tmp_path, 256, 128, 2, bk)
    for mode in ("bf16", "int8"):
        monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", mode)
        assert model.warmup() == 2
        name = f"quantized_matmul_{mode}"
        tok, pos, mask = serving.export.prefill_feeds(
            [[1, 2, 3]] * 128, 8, 128)
        kreg.reset_counts()
        _, k, v = model.prefill(tok, pos, mask)
        assert kreg.launches()[name] == 13
        t, p, m = serving.export.decode_feeds([5] * 128, [3] * 128, 16,
                                              128)
        ck = torch.zeros((2, 128, 16, 128), device=cuda)
        kreg.reset_counts()
        model.decode(t, p, m, ck, ck)
        assert kreg.launches()[name] == 13
        if mode == "bf16":
            eng = serving.ServingEngine(model)
            reqs = [eng.submit(pr, max_new_tokens=6)
                    for pr in _BOOK_PROMPTS]
            while eng.pending():
                eng.step()
            for r, pr in zip(reqs, _BOOK_PROMPTS):
                assert r.tokens == serving.reference_generate(model, pr, 6)


def test_serve_server_threads_match_engine_on_card(cuda, tmp_path):
    """ServeServer replays the graphs from its loop thread; four client
    threads get the tokens the in-process engine gives."""
    import socket
    import threading
    from paddle_tpu_torch.inference import serving
    bk = serving.BucketSpec(batch=3, prefill_lens=(8,), cache_lens=(24,))
    model = _book_lm_on_card(tmp_path, 29, 8, 2, bk)
    model.warmup()
    c0 = dict(model.engine_counters())
    eng = serving.ServingEngine(model)
    want = [eng.submit(p, max_new_tokens=6) for p in _BOOK_PROMPTS]
    while eng.pending():
        eng.step()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    ep = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    srv = serving.ServeServer(ep, serving.ServingEngine(model)).start()
    got = {}

    def client(i):
        got[i] = serving.generate(ep, _BOOK_PROMPTS[i], max_new_tokens=6,
                                  timeout=120.0)

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(_BOOK_PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
    finally:
        assert srv.shutdown() is True
    assert [got[i]["tokens"] for i in range(len(_BOOK_PROMPTS))] == \
        [r.tokens for r in want]
    c1 = model.engine_counters()
    assert (c1["captures"], c1["eager_runs"]) == (c0["captures"],
                                                  c0["eager_runs"])


# ---------------------------------------------------------------------------
# [sequence phase]: LoD batches, the sequence and recurrent ops
# ---------------------------------------------------------------------------

_SEQ_LOD = [[0, 3, 3, 7, 8]]      # four sequences, one of length 0


def _seq_op_view(op_type, inputs, outputs, attrs):
    from paddle_tpu_torch.core.registry import _SlotView
    return _SlotView(op_type, {s: [s.lower()] for s in inputs},
                     {s: [n] for s, n in outputs.items()}, dict(attrs))


def _seq_run(op_type, inputs, outputs, attrs, lods, dev, cts=None,
             grads_of=()):
    """The op's outputs, and with `cts` (output slot -> cotangent) the
    gradients of `grads_of` through its grad lowering, on `dev`."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext
    names = {s: s.lower() + "_out" for s in outputs}
    env = {s.lower(): torch.from_numpy(np.array(a)).to(dev)
           for s, a in inputs.items()}
    OPS.get(op_type).lowering(ExecContext(
        _seq_op_view(op_type, inputs, names, attrs), env, dev, None,
        dict(lods)))
    outs = {s: env[n].cpu() for s, n in names.items()}
    if not cts:
        return outs, {}
    g_inputs = {**inputs, **{s: outs[s].numpy() for s in outputs}}
    g_inputs.update({s + "@GRAD": c for s, c in cts.items()})
    view = _seq_op_view(op_type + "_grad", g_inputs,
                        {s + "@GRAD": s.lower() + "@g" for s in grads_of},
                        attrs)
    for s in outputs:
        if s not in cts:
            view._inputs[s + "@GRAD"] = [""]
    genv = {s.lower(): torch.from_numpy(np.array(a)).to(dev)
            for s, a in g_inputs.items()}
    OPS.get(op_type + "_grad").lowering(ExecContext(view, genv, dev, None,
                                                    dict(lods)))
    return outs, {s: genv[s.lower() + "@g"].cpu() for s in grads_of}


def _seq_cases():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lod = {"x": _SEQ_LOD}
    cases = [("sequence_pool", {"X": x}, ["Out"], {"pooltype": p}, lod,
              ["X"]) for p in ("AVERAGE", "SUM", "SQRT", "MAX", "LAST",
                               "FIRST")]
    cases += [
        ("sequence_softmax", {"X": f(8, 1)}, ["Out"], {}, lod, ["X"]),
        ("sequence_reverse", {"X": x}, ["Y"], {}, lod, ["X"]),
        ("sequence_conv", {"X": x, "Filter": f(15, 6)}, ["Out"],
         {"contextLength": 3, "contextStart": -1}, lod, ["X", "Filter"]),
        ("sequence_pad", {"X": x, "PadValue": np.array([0.5], np.float32)},
         ["Out"], {"padded_length": -1}, lod, ["X"]),
        ("sequence_expand_as", {"X": f(4, 3), "Y": f(8, 1)}, ["Out"], {},
         {"y": _SEQ_LOD}, ["X"]),
        ("sequence_scatter", {"X": f(4, 6), "Ids": np.array(
            [[0], [5], [1], [2], [2], [0], [3], [4]], np.int64),
            "Updates": f(8, 1)}, ["Out"], {}, {"ids": _SEQ_LOD},
         ["X", "Updates"]),
        ("lstm", {"Input": f(8, 20), "Weight": f(5, 20), "Bias": f(1, 35),
                  "H0": f(4, 5), "C0": f(4, 5)}, ["Hidden", "Cell"],
         {"use_peepholes": True, "is_reverse": True}, {"input": _SEQ_LOD},
         ["Input", "Weight", "Bias", "H0"]),
        ("gru", {"Input": f(8, 15), "Weight": f(5, 15), "Bias": f(1, 15)},
         ["Hidden"], {"is_reverse": False, "origin_mode": True},
         {"input": _SEQ_LOD}, ["Input", "Weight", "Bias"]),
    ]
    return cases


_SEQ_CASES = _seq_cases()


@pytest.mark.parametrize("case", range(len(_SEQ_CASES)), ids=[
    f"{c[0]}-{c[3].get('pooltype', i)}" for i, c in enumerate(_SEQ_CASES)])
def test_sequence_op_on_card_matches_cpu(cuda, case):
    """Each sequence and recurrent op and its gradient on the card
    against the same lowering on the CPU (F32_TOL; backward BWD_F32_TOL)."""
    op_type, inputs, outs, attrs, lods, grads_of = _SEQ_CASES[case]
    rng = np.random.default_rng(case)
    ref, _ = _seq_run(op_type, inputs, outs, attrs, lods,
                      torch.device("cpu"))
    cts = {s: rng.standard_normal(tuple(ref[s].shape)).astype(np.float32)
           for s in outs}
    cpu = _seq_run(op_type, inputs, outs, attrs, lods, torch.device("cpu"),
                   cts, grads_of)
    card = _seq_run(op_type, inputs, outs, attrs, lods, cuda, cts, grads_of)
    for s in outs:
        torch.testing.assert_close(card[0][s], cpu[0][s], rtol=F32_TOL,
                                   atol=F32_TOL)
    for s in grads_of:
        torch.testing.assert_close(card[1][s], cpu[1][s], rtol=BWD_F32_TOL,
                                   atol=BWD_F32_TOL)


def _seq_tiny(net):
    from paddle_tpu_torch.models import sentiment
    pt.framework.unique_name.reset()
    main, startup, cost, acc, pred = sentiment.sentiment_train(
        net, input_dim=100, emb_dim=16, hid_dim=32)
    main.random_seed = startup.random_seed = 3
    return main, startup, cost, acc, pred


def _seq_feeds(place, seeds=(0, 1)):
    feeds = []
    for s in seeds:
        rng = np.random.RandomState(s)
        lens = [int(n) for n in rng.randint(1, 30, 6)]
        ids = rng.randint(0, 100, (sum(lens), 1)).astype(np.int64)
        feeds.append({"words": pt.create_lod_tensor(ids, [lens], place),
                      "label": rng.randint(0, 2, (6, 1)).astype(np.int64)})
    return feeds


@pytest.mark.parametrize("net", ["stacked_lstm", "conv"])
def test_sentiment_steps_captured_bit_equal_eager_on_card(cuda, monkeypatch,
                                                          net):
    """Two LoD batches, three runs each with the plan cache (eager, the
    capture, a replay: one graph a LoD) and the same runs with
    use_program_cache=False, from one startup state in deterministic
    mode: bit-equal fetches and persistables, no kernel of the port
    launched, no index tensor made after a plan's first run."""
    old = _deterministic(monkeypatch)
    main, startup, cost, acc, _ = _seq_tiny(net)
    feeds = _seq_feeds(pt.CUDAPlace(0)) * 3
    try:
        runs = {}
        for cached in (True, False):
            exe, scope = pt.Executor(), pt.Scope()
            exe.run(startup, scope=scope)
            kreg.reset_counts()
            out, built = [], []
            for f in feeds:
                out.append([np.asarray(v) for v in exe.run(
                    main, feed=f, fetch_list=[cost, acc], scope=scope,
                    use_program_cache=cached)])
                plans = exe._engine._plans.get(
                    exe._engine._key(main, [cost.name, acc.name]), [])
                built.append(sum(p.host_tables.built for p in plans))
            assert not any(kreg.launches().values())
            state = {v.name: scope.find_var(v.name).get_tensor().tensor
                     .clone() for v in main.global_block().vars.values()
                     if v.persistable and scope.find_var(v.name)
                     is not None}
            runs[cached] = (out, state, dict(exe._engine.counters), built,
                            dict(exe._engine.eager_reasons))
            exe.close()
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    (oa, sa, ca, built, reasons), (ob, sb, _, _, _) = runs[True], runs[False]
    assert not reasons
    # eager: the startup program's run and each plan's first
    assert (ca["captures"], ca["replays"], ca["eager_runs"]) == (2, 4, 3)
    assert built[1] > built[0] > 0 and built[2:] == [built[1]] * 4
    for a, b in zip(oa, ob):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


def test_lod_predictor_on_card_matches_executor(cuda, tmp_path):
    """The tiny stacked net saved; the predictor on the card on two LoD
    signatures: warmup captures each once, later runs replay with no
    capture, the outputs equal the Executor's eager forward."""
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    main, startup, cost, _, pred = _seq_tiny("stacked_lstm")
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feeds = _seq_feeds(pt.CPUPlace())
    test = pt.io._prune_program(main, [pred.name])
    refs = [np.asarray(exe.run(test, feed=f, fetch_list=[pred], scope=scope,
                               use_program_cache=False)[0]) for f in feeds]
    with pt.scope_guard(scope):
        pt.io.save_inference_model(str(tmp_path), ["words"], [pred], exe,
                                   main_program=main)
    predictor = create_paddle_predictor(AnalysisConfig(str(tmp_path)))
    it = predictor.get_input_tensor("words")
    ot = predictor.get_output_tensor(predictor.get_output_names()[0])
    for rnd in range(3):
        if rnd == 2:
            before = dict(predictor._engine.counters)
        for f, ref in zip(feeds, refs):
            it.copy_from_cpu(np.asarray(f["words"]))
            it.set_lod(f["words"].lod())
            predictor.zero_copy_run()
            torch.testing.assert_close(torch.from_numpy(ot.copy_to_cpu()),
                                       torch.from_numpy(ref), rtol=F32_TOL,
                                       atol=F32_TOL)
    c = predictor._engine.counters
    assert c["captures"] == 2 == before["captures"]
    assert c["eager_runs"] == 2 and c["replays"] == 4


# ---------------------------------------------------------------------------
# sub-blocks: the recurrent block, While, and sequence_pool over empty
# sequences
# ---------------------------------------------------------------------------

def _s2s_tiny():
    from paddle_tpu_torch.models import seq2seq
    pt.framework.unique_name.reset()
    main, startup, loss, logits = seq2seq.seq2seq_train(
        src_vocab=50, tgt_vocab=50, word_dim=16, hidden_dim=32)
    return main, startup, loss, logits


def _s2s_feeds(place, seeds=(0, 1)):
    from paddle_tpu_torch.models import seq2seq
    return [seq2seq.wmt14_batch(np.random.default_rng(s), 6, 50, 50,
                                place=place, median=5.0, lo=1, hi=12)
            for s in seeds]


def test_recurrent_steps_captured_bit_equal_eager_on_card(cuda, monkeypatch):
    """The tiny encoder-decoder (two DynamicRNN blocks): two LoD
    batches, three runs each with the plan cache (eager, the capture, a
    replay) and the same runs with use_program_cache=False from one
    startup state in deterministic mode: fetches and persistables
    bit-equal, no block kept eager."""
    old = _deterministic(monkeypatch)
    main, startup, loss, _ = _s2s_tiny()
    feeds = _s2s_feeds(pt.CUDAPlace(0)) * 3
    try:
        runs = {}
        for cached in (True, False):
            exe, scope = pt.Executor(), pt.Scope()
            exe.run(startup, scope=scope)
            out = [np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                      scope=scope,
                                      use_program_cache=cached)[0])
                   for f in feeds]
            state = {v.name: scope.find_var(v.name).get_tensor().tensor
                     .clone() for v in main.global_block().vars.values()
                     if v.persistable and scope.find_var(v.name)
                     is not None}
            runs[cached] = (out, state, dict(exe._engine.counters),
                            dict(exe._engine.eager_reasons))
            exe.close()
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    (oa, sa, ca, reasons), (ob, sb, _, _) = runs[True], runs[False]
    assert not reasons
    assert (ca["captures"], ca["replays"], ca["eager_runs"]) == (2, 4, 3)
    for a, b in zip(oa, ob):
        np.testing.assert_array_equal(a, b)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


def test_seq2seq_adam_is_one_launch_a_step_on_card(cuda, monkeypatch):
    """With every parameter routed (PT_KERNEL_MIN_NUMEL=1), each step of
    the tiny encoder-decoder, eager or replayed, is one fused_adam launch
    over all ten parameters."""
    monkeypatch.setenv("PT_KERNEL_MIN_NUMEL", "1")
    main, startup, loss, _ = _s2s_tiny()
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(startup, scope=scope)
    feed = _s2s_feeds(pt.CUDAPlace(0), seeds=(0,))[0]
    kreg.reset_counts()
    kreg.reset_stats()
    for _ in range(4):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    n_params = len(main.all_parameters())
    assert n_params == 10
    assert kreg.launches()["fused_adam"] == 4
    assert kreg.dispatch_stats()["per_kernel"]["fused_adam"]["custom"] == \
        4 * n_params
    # runs 2-4: the capture (and its replay), then two replays
    assert exe._engine.counters["replays"] == 3


def test_while_block_runs_eager_on_card(cuda):
    """A While loop: its condition is read on the host every trip, so
    the engine keeps the block eager and records why; the result equals
    the CPU's."""
    L = pt.layers
    outs = {}
    for place in (pt.CPUPlace(), pt.CUDAPlace(0)):
        pt.framework.unique_name.reset()
        main, startup = pt.Program(), pt.Program()
        with pt.program_guard(main, startup):
            x = L.data("x", [3], dtype="float32")
            i = L.fill_constant([1], "float32", 0.0)
            n = L.fill_constant([1], "float32", 5.0)
            acc = L.assign(x)
            cond = L.less_than(i, n)
            loop = L.While(cond)
            with loop.block():
                L.assign(L.elementwise_add(acc * 0.5, x), output=acc)
                L.increment(i, in_place=True)
                L.less_than(i, n, cond=cond)
            out = acc * 1.0
        exe = pt.Executor(place)
        feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
        for _ in range(3):
            outs[place.torch_device().type] = exe.run(
                main, feed=feed, fetch_list=[out])[0]
        if place.torch_device().type == "cuda":
            assert list(exe._engine.eager_reasons.values()) == ["while"]
            assert exe._engine.counters["captures"] == 0
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("lod", [[0, 0, 0], [0, 0, 3]])
def test_sequence_pool_max_over_empty_sequences_on_card(cuda, lod):
    """MAX pooling where every (or one) sequence is empty: pad_value
    rows, as on the CPU."""
    from paddle_tpu_torch.core.registry import OPS, ExecContext
    x = np.arange(lod[-1] * 3, dtype=np.float32).reshape(-1, 3)
    res = {}
    for dev in (torch.device("cpu"), cuda):
        view = _seq_op_view("sequence_pool", {"X": x},
                            {"Out": "out", "MaxIndex": "mi"},
                            {"pooltype": "MAX", "pad_value": 2.0})
        env = {"x": torch.from_numpy(x).to(dev)}
        OPS.get("sequence_pool").lowering(ExecContext(view, env, dev, None,
                                                      {"x": [lod]}))
        res[dev.type] = env["out"].cpu()
    assert torch.equal(res["cuda"], res["cpu"])
    assert torch.equal(res["cpu"][0], torch.full((3,), 2.0))


# ---------------------------------------------------------------------------
# the book's last two models: the CRF tagger and the beam-search decoder
# ---------------------------------------------------------------------------

def _cached_against_eager(main, startup, feeds, fetch, monkeypatch,
                          init=None):
    """`feeds` run in turn through the plan cache and with
    use_program_cache=False, each from one startup state (or the scope
    `init` copies), in deterministic mode: (fetches, persistables,
    counters, eager reasons) of each way, keyed by cached."""
    old = _deterministic(monkeypatch)
    runs = {}
    try:
        for cached in (True, False):
            exe, scope = pt.Executor(), pt.Scope()
            if init is None:
                exe.run(startup, scope=scope)
            else:
                for n, v in init._vars.items():
                    scope.var(n).get_tensor().set_tensor(
                        v.get_tensor().tensor.clone())
            out = [[np.asarray(v) for v in exe.run(
                main, feed=f, fetch_list=fetch, scope=scope,
                use_program_cache=cached)] for f in feeds]
            state = {n: v.get_tensor().tensor.clone()
                     for n, v in scope._vars.items()}
            runs[cached] = (out, state, dict(exe._engine.counters),
                            dict(exe._engine.eager_reasons))
            exe.close()
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    return runs


def _assert_bit_equal(runs):
    (oa, sa, _, _), (ob, sb, _, _) = runs[True], runs[False]
    for x, y in zip(oa, ob):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


def test_srl_steps_and_decode_captured_bit_equal_eager_on_card(
        cuda, monkeypatch):
    """The tiny CRF tagger (models/label_semantic_roles.py: a DynamicRNN
    block, linear_chain_crf and its generic gradient, Adam): two LoD
    batches, three runs each with the plan cache (eager, the capture, a
    replay) and the same runs with use_program_cache=False, fetches and
    persistables bit-equal, no block kept eager; then its decode program
    (crf_decoding) on the trained scope, captured against eager: the
    same Viterbi paths with the feed's LoD."""
    from paddle_tpu_torch.models import label_semantic_roles as srl
    widths = {"vocab": 50, "n_tag": 5, "emb_dim": 16, "hidden_dim": 32}
    pt.framework.unique_name.reset()
    main, startup, loss, _ = srl.srl_train(**widths)
    with pytest.warns(UserWarning, match="crfw"):
        decode, path = srl.srl_decode(**widths)
    feeds = [srl.conll05_batch(np.random.default_rng(s), 6, 50, 5,
                               pt.CUDAPlace(0)) for s in (0, 1)]
    runs = _cached_against_eager(main, startup, feeds * 3, [loss],
                                 monkeypatch)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons
    assert (c["captures"], c["replays"], c["eager_runs"]) == (2, 4, 3)
    trained = pt.Scope()
    for n, t in runs[True][1].items():
        trained.var(n).get_tensor().set_tensor(t)
    words = [{"word": f["word"]} for f in feeds]
    dec = _cached_against_eager(decode, None, words * 3, [path],
                                monkeypatch, init=trained)
    _assert_bit_equal(dec)
    assert dec[True][0][0][0].dtype == np.int32
    assert dec[True][2]["captures"] == 2 and not dec[True][3]


def _mt_tiny(width=128, vocab=50, beam=4, max_len=6):
    from paddle_tpu_torch.models import machine_translation as mt
    pt.framework.unique_name.reset()
    main, startup, loss = mt.mt_train(vocab=vocab, word_dim=width,
                                      hidden_dim=width)
    decode, ids, scores = mt.mt_decode(vocab=vocab, word_dim=width,
                                       hidden_dim=width, beam=beam,
                                       max_len=max_len)
    return main, startup, loss, decode, ids, scores


@pytest.mark.parametrize("mode", ["", "int8", "bf16"])
def test_beam_decode_captured_bit_equal_eager_on_card(cuda, monkeypatch,
                                                      mode):
    """The tiny beam-search decoder (models/machine_translation.py,
    width 128, beam 4, 6 steps) on 128 sources: the decode program's
    runs through the plan cache (eager, the capture, replays) bit-equal
    to eager runs, in float32 and with every eligible GEMM in the
    int8 / bf16 kernel. Each eligible `mul` launches its kernel: the
    encoder's two step GEMMs at M = 128 a source step and the
    decoder's two at M = 128 (step 0) then 512 a decode step; the
    softmax fc (N = 50) stays on cuBLAS."""
    from paddle_tpu_torch.models import machine_translation as mt
    if mode:
        monkeypatch.setenv("PT_KERNEL_QUANT_MATMUL", mode)
    main, startup, _, decode, ids, scores = _mt_tiny()
    init = pt.Scope()
    pt.Executor().run(startup, scope=init)
    feed = mt.decode_feed(np.random.default_rng(3), 128, 50,
                          pt.CUDAPlace(0), median=5.0, lo=2, hi=9)
    runs = _cached_against_eager(decode, None, [feed] * 3, [ids, scores],
                                 monkeypatch, init=init)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 1)
    kreg.reset_counts()
    exe = pt.Executor()
    exe.run(decode, feed=feed, fetch_list=[ids], scope=init,
            use_program_cache=False)
    n = {k: v for k, v in kreg.launches().items() if v}
    if mode:
        t_src = int(np.diff(feed["src"].lod()[0]).max())
        assert n == {f"quantized_matmul_{mode}": 2 * t_src + 2 * 6}, n
    else:
        assert not n, n
    got = runs[True][0][0]
    assert got[0].shape == (128 * 4, 6) and got[0].dtype == np.int32
    assert np.isfinite(got[1]).all()


# ---------------------------------------------------------------------------
# the bucket sweep, flash_attention_lse, the op families
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
@pytest.mark.parametrize("n", [1, 129, 256 * 128 * 3 + 7],
                         ids=["1", "129", "3blocks+7"])
def test_bucket_sweep_kernel_equals_plain_on_card(cuda, kind, n):
    """One launch a sweep, bit-equal to the plain version, with weight
    decay, a guard spike, every ZeRO-1 window of 4 and views off a
    16-byte boundary (the element-by-element path)."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    gen = torch.Generator(device=cuda).manual_seed(n)
    buf = torch.randn(3 * n + 1, generator=gen, device=cuda)
    v = torch.rand(n, generator=gen, device=cuda)
    for off in (0, 1):
        p, g, m = (buf[off + i * n: off + (i + 1) * n] for i in range(3))
        args = (p, g, m, v) if kind == "adam" else (p, g)
        for shard in [None] + [(i, 4) for i in range(4)]:
            kw = dict(lr=torch.tensor(1e-3, device=cuda),
                      weight_decay=0.01, shard=shard,
                      guard=(0.0, 1.0, 0.5))
            if kind == "adam":
                kw.update(beta1_pow=0.9 ** 3, beta2_pow=0.999 ** 3)
            kreg.reset_counts()
            got = fo.bucket_sweep(kind, *args, **kw)
            torch.cuda.synchronize()
            assert kreg.launches()["bucket_sweep_" + kind] == 1
            with kreg.plain_reference():
                want = fo.bucket_sweep(kind, *args, **kw)
            got = got if kind == "adam" else (got,)
            want = want if kind == "adam" else (want,)
            for a, b in zip(got, want):
                assert torch.equal(_bits(a), _bits(b)), (kind, n, shard)


def _sweep_case(kind, n, gen, dev):
    p, g, m = (torch.randn(n, generator=gen, device=dev) for _ in range(3))
    v = torch.rand(n, generator=gen, device=dev)
    return (p, g, m, v) if kind == "adam" else (p, g)


def _sweep_pows(kind, b1p, b2p):
    return dict(beta1_pow=b1p, beta2_pow=b2p) if kind == "adam" else {}


@pytest.mark.parametrize("kind", ["adam", "sgd"])
@pytest.mark.parametrize("n, num", [(98004, 96), (8145920, 4),
                                    (16384000, 4)],
                         ids=["edges-in-chunks", "ragged-chunk",
                              "16384000"])
def test_bucket_sweep_chunk_edges_on_card(cuda, kind, n, num):
    """Windows whose edges fall inside a chunk of the kernel (96 shards
    of 768 padded rows: an edge every 1024 elements), a view that is no
    whole number of chunks, and one 16,384,000-element bucket (an
    embedding's): one launch, bit-equal to the plain version, and the
    rows outside the window are the inputs bit for bit."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    gen = torch.Generator(device=cuda).manual_seed(n)
    args = _sweep_case(kind, n, gen, cuda)
    olds = (args[0], args[2], args[3]) if kind == "adam" else args[:1]
    per = fo.rows_padded(n) // num * 128
    for i in sorted({0, 1, num // 2 - 1, num - 1}):
        for guard in (None, (0.0, 1.0, 0.5)):
            kw = dict(lr=torch.tensor(1e-3, device=cuda), shard=(i, num),
                      guard=guard, **_sweep_pows(kind, 0.9 ** 3,
                                                 0.999 ** 3))
            kreg.reset_counts()
            got = fo.bucket_sweep(kind, *args, **kw)
            torch.cuda.synchronize()
            assert kreg.launches()["bucket_sweep_" + kind] == 1
            with kreg.plain_reference():
                want = fo.bucket_sweep(kind, *args, **kw)
            got = got if kind == "adam" else (got,)
            want = want if kind == "adam" else (want,)
            lo, hi = min(i * per, n), min((i + 1) * per, n)
            for a, b, old in zip(got, want, olds):
                assert torch.equal(_bits(a), _bits(b)), (kind, n, i, guard)
                assert torch.equal(_bits(a[:lo]), _bits(old[:lo]))
                assert torch.equal(_bits(a[hi:]), _bits(old[hi:]))


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_bucket_sweep_replay_rereads_pows_and_shard(cuda, kind):
    """A captured sweep whose beta powers and shard index are tensors:
    replays after they change equal the eager sweep given the new values
    as numbers, and the plain version."""
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    n = 8145920
    gen = torch.Generator(device=cuda).manual_seed(19)
    args = _sweep_case(kind, n, gen, cuda)
    lr = torch.tensor([1e-3], device=cuda)
    b1p, b2p = (torch.tensor([b ** 3], device=cuda) for b in (0.9, 0.999))
    idx = torch.zeros((), dtype=torch.int64, device=cuda)

    def sweep():
        return fo.bucket_sweep(kind, *args, lr=lr, shard=(idx, 4),
                               **_sweep_pows(kind, b1p, b2p))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sweep()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap = sweep()
    cap = cap if kind == "adam" else (cap,)
    for step, i in ((7, 2), (20, 3), (1, 0)):
        b1p.fill_(0.9 ** step)
        b2p.fill_(0.999 ** step)
        idx.fill_(i)
        graph.replay()
        kw = dict(lr=lr, shard=(i, 4),
                  **_sweep_pows(kind, 0.9 ** step, 0.999 ** step))
        eager = fo.bucket_sweep(kind, *args, **kw)
        with kreg.plain_reference():
            plain = fo.bucket_sweep(kind, *args, **kw)
        torch.cuda.synchronize()
        eager = eager if kind == "adam" else (eager,)
        plain = plain if kind == "adam" else (plain,)
        for a, b, c in zip(cap, eager, plain):
            assert torch.equal(_bits(a), _bits(b)), (kind, step, i)
            assert torch.equal(_bits(a), _bits(c)), (kind, step, i)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_bucket_sweep_is_one_kernel_on_card(cuda, kind):
    """Under torch.profiler a sweep given tensors on the card (rate, beta
    powers, guard, shard index) runs one kernel, bucket_sweep_<kind>'s,
    and nothing else. A session may lose its first kernels' events, so
    each launches four sleep kernels (not counted) before the sweep; up
    to five sessions, one of which must see the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    gen = torch.Generator(device=cuda).manual_seed(1)
    args = _sweep_case(kind, 3414528, gen, cuda)
    f32 = [torch.tensor(x, device=cuda) for x in (1e-3, 0.0, 1.0, 0.5)]
    kw = dict(lr=f32[0], guard=tuple(f32[1:]),
              shard=(torch.tensor(1, device=cuda), 4),
              **_sweep_pows(kind, torch.tensor(0.9, device=cuda),
                            torch.tensor(0.999, device=cuda)))
    fo.bucket_sweep(kind, *args, **kw)
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fo.bucket_sweep(kind, *args, **kw)
            torch.cuda.synchronize()
        kernels = [(e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and "spin_kernel" not in e.key]
        assert all("bucket_sweep_" + kind in k for k, _ in kernels), kernels
        seen.append(sum(c for _, c in kernels))
        if seen[-1] == 1:
            break
    assert seen[-1] == 1 and max(seen) == 1, seen


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_bucket_sweep_graph_is_one_kernel(cuda, kind):
    """A CUDA graph captured from one sweep given tensors on the card
    holds one node, a bucket_sweep_<kind> kernel (read through the driver
    API by chip_smoke._graph_kernels, which no profiler can drop)."""
    import chip_smoke
    from paddle_tpu_torch.kernels import fused_optimizer as fo
    gen = torch.Generator(device=cuda).manual_seed(2)
    args = _sweep_case(kind, 787456, gen, cuda)
    f32 = [torch.tensor(x, device=cuda) for x in (1e-3, 0.0, 1.0, 0.5)]
    kw = dict(lr=f32[0], guard=tuple(f32[1:]),
              shard=(torch.tensor(2, device=cuda), 4),
              **_sweep_pows(kind, torch.tensor(0.9, device=cuda),
                            torch.tensor(0.999, device=cuda)))
    fo.bucket_sweep(kind, *args, **kw)
    torch.cuda.synchronize()
    nodes = chip_smoke._graph_kernels(
        torch, lambda: fo.bucket_sweep(kind, *args, **kw))
    assert len(nodes) == 1 and "bucket_sweep_" + kind in nodes[0], nodes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_lse_on_card(cuda, dtype):
    """g_lse = 0 gives fused_attention_backward's gradients bit for bit;
    a random g_lse is held to float64 exact gradients (float32:
    BWD_F32_TOL; bf16: bf16_backward_bound)."""
    B, H, S, D = 2, 4, 96, 64
    gen = torch.Generator(device=cuda).manual_seed(18)
    q, k, v, g = (torch.randn((B, H, S, D), generator=gen,
                              device=cuda).to(dtype) for _ in range(4))
    gl = torch.randn((B, H, S), generator=gen, device=cuda)
    bias = torch.zeros((B, 1, 1, S), device=cuda)
    bias[1, ..., S - 20:] = -1e9
    scale = D ** -0.5
    grads = {}
    for label, lse_ct in (("zero", torch.zeros_like(gl)), ("random", gl)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out, lse = pfa.flash_attention_lse(*leaves, bias, scale)
        torch.autograd.backward([out, lse], [g, lse_ct])
        grads[label] = [x.grad for x in leaves]
    out, lse = pfa.fused_attention_forward(q, k, v, bias, scale, False,
                                           "bhsd", return_lse=True)
    ref = pfa.fused_attention_backward(q, k, v, bias, out, lse, g, scale,
                                       False, "bhsd")
    for a, b in zip(grads["zero"], ref):
        assert torch.equal(a, b)
    if dtype == torch.bfloat16:
        exact, bound = pfa.bf16_backward_bound(q, k, v, bias, out, lse, g,
                                               scale, False, "bhsd",
                                               g_lse=gl)
        for a, e, w in zip(grads["random"], exact, bound):
            assert bool(((a.double() - e).abs() <= w).all())
        return
    qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
    s = qd @ kd.transpose(-1, -2) * scale + bias.double()
    torch.autograd.backward([torch.softmax(s, -1) @ vd,
                             torch.logsumexp(s, -1)],
                            [g.double(), gl.double()])
    for a, e in zip(grads["random"], (qd.grad, kd.grad, vd.grad)):
        torch.testing.assert_close(a.double(), e, rtol=BWD_F32_TOL,
                                   atol=BWD_F32_TOL)


def test_op_families_on_card_equal_the_cpu(cuda):
    """Every case of ops/family_cases.py through its lowering on the card
    and on the CPU: float32 within F32_TOL, the rest exact, LoDs
    equal."""
    from paddle_tpu_torch.ops import family_cases as fc
    runs = [(c[0], c[1], c[2], c[3], None) for cs in fc.cases().values()
            for c in cs]
    runs += [(c[0], c[1], c[3], {s: 1 for s in c[4]}, c[2])
             for c in fc.sequence_cases() + fc.detection_cases()]
    for op_type, ins, attrs, outs, lods in runs:
        card, clod = fc.run(op_type, ins, attrs, outs, cuda, lods)
        cpu, plod = fc.run(op_type, ins, attrs, outs, "cpu", lods)
        for n, v in card.items():
            a, b = v.cpu(), cpu[n]
            assert a.dtype == b.dtype and a.shape == b.shape, op_type
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)
            else:
                assert torch.equal(a, b), op_type
            assert clod[n] == plod[n], op_type


def test_ssd_full_width_captured_bit_equal_eager_on_card(cuda, monkeypatch):
    """chip_smoke's MobileNet-SSD at full width (scale 1.0, 300x300, 21
    classes, 1917 priors) with ssd_loss, RMSProp and L2Decay, at B=8 on
    two VOC-shaped LoD batches: three runs each through the plan cache
    (eager, the capture, a replay) bit-equal to the same runs eager, in
    deterministic mode; no block kept eager."""
    import chip_smoke as cs
    pt.framework.unique_name.reset()
    main, startup, loss, head = cs.ssd_train(pt, 21, 300, 1.0, batch=8)
    assert int(head[2].shape[0]) == 1917
    feeds = [cs._train_feed(cs._voc_batch(torch, pt, s, pt.CUDAPlace(0),
                                          B=8)) for s in (0, 1)]
    runs = _cached_against_eager(main, startup, feeds * 3, [loss],
                                 monkeypatch)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons
    # eager runs: the startup program's and each batch's first
    assert (c["captures"], c["replays"], c["eager_runs"]) == (2, 4, 3)
    assert all(np.isfinite(o[0]).all() for o in runs[True][0])


def test_multiclass_nms_full_size_on_card_equals_cpu(cuda):
    """multiclass_nms at MobileNet-SSD's detection shape (64 images, 21
    classes, 1917 priors; nms_top_k 400, keep_top_k 200, threshold 0.45)
    on the card: the rows the CPU gives, with ties in the scores."""
    from paddle_tpu_torch.ops import family_cases as fc
    rng = np.random.default_rng(0)
    boxes = fc._boxes(rng, 64, 1917)
    scores = rng.dirichlet(np.ones(21), (64, 1917)).astype(
        np.float32).transpose(0, 2, 1).copy()
    scores[:, 3, 100:110] = scores[:, 3, 100:101]      # equal scores
    attrs = {"score_threshold": 0.01, "nms_top_k": 400, "keep_top_k": 200,
             "nms_threshold": 0.45, "normalized": False, "nms_eta": 1.0,
             "background_label": 0}
    ins = {"BBoxes": boxes, "Scores": scores}
    card, clod = fc.run("multiclass_nms", ins, attrs, {"Out": 1}, cuda)
    cpu, plod = fc.run("multiclass_nms", ins, attrs, {"Out": 1}, "cpu")
    a, b = card["out_out0"].cpu(), cpu["out_out0"]
    assert a.shape == (64 * 200, 6) and clod == plod
    assert torch.equal(a, b)
    assert (a[:, 0] >= 0).sum() > 64 * 50


# the update ops whose lowering reduces over a whole tensor (the LARS
# and LAMB norms): the card sums in another order than the CPU
NORM_UPDATES = ("lars_momentum", "lamb")


def test_update_ops_on_card_equal_the_cpu(cuda):
    """Each update op with no kernel (ops/family_cases.py's "optimizer"
    cases) on the card: bit-equal to the CPU (every square root
    correctly rounded on both), but for lars_momentum and lamb, whose
    norms the card sums in another order: within F32_TOL."""
    from paddle_tpu_torch.ops import family_cases as fc
    for op_type, ins, attrs, outs, _ in fc.cases()["optimizer"]:
        card, _ = fc.run(op_type, ins, attrs, outs, cuda)
        cpu, _ = fc.run(op_type, ins, attrs, outs, "cpu")
        for n, v in card.items():
            if op_type in NORM_UPDATES:
                torch.testing.assert_close(v.cpu(), cpu[n], rtol=F32_TOL,
                                           atol=F32_TOL)
            else:
                assert torch.equal(v.cpu(), cpu[n]), (op_type, n)


def _no_tf32(monkeypatch):
    """cuDNN's convolutions in full float32, as chip_smoke.py runs them
    (torch's default lets cuDNN use TF32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def test_conv_family_on_card_equals_the_cpu(cuda, monkeypatch):
    """Every case of ops/family_cases.py's conv_cases() through its
    lowering on the card and on the CPU, and its `<op>_grad` lowering
    under one random cotangent of every float output: float32 within
    F32_TOL forward, BWD_F32_TOL backward (a filter's gradient sums over
    the batch and every position), max_pool2d_with_index's Mask
    exactly."""
    from paddle_tpu_torch.ops import family_cases as fc
    _no_tf32(monkeypatch)
    rng = np.random.default_rng(5)
    for op_type, ins, attrs, outs, diff in fc.conv_cases():
        card, _ = fc.run(op_type, ins, attrs, outs, cuda)
        cpu, _ = fc.run(op_type, ins, attrs, outs, "cpu")
        for n, v in card.items():
            a, b = v.cpu(), cpu[n]
            assert a.dtype == b.dtype and a.shape == b.shape, (op_type, n)
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)
            else:
                assert torch.equal(a, b), (op_type, n)
        if not diff:
            continue
        g_ins = dict(ins)
        for slot, count in outs.items():
            v = cpu[f"{slot.lower()}_out0"]
            if count == 1 and v.is_floating_point():
                g_ins[slot] = v.numpy()
                g_ins[slot + "@GRAD"] = rng.standard_normal(
                    tuple(v.shape)).astype(np.float32)
        g_outs = {s + "@GRAD": 1 for s in diff}
        gcard, _ = fc.run(op_type + "_grad", g_ins, attrs, g_outs, cuda)
        gcpu, _ = fc.run(op_type + "_grad", g_ins, attrs, g_outs, "cpu")
        for n, v in gcard.items():
            torch.testing.assert_close(v.cpu(), gcpu[n], rtol=BWD_F32_TOL,
                                       atol=BWD_F32_TOL)


@pytest.mark.parametrize("op_type", ["conv2d_transpose",
                                     "depthwise_conv2d_transpose",
                                     "conv3d_transpose"])
def test_transposed_convolution_under_amp_on_card(cuda, monkeypatch,
                                                  op_type):
    """Under amp_guard a transposed convolution computes in bf16 on the
    card as on the CPU: conv2d_transpose returns bf16, the other two
    float32 (the JAX op's dtypes), within BF16_TOL of the CPU's largest
    value."""
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import family_cases as fc
    _no_tf32(monkeypatch)
    case = next(c for c in fc.conv_cases() if c[0] == op_type)
    with amp.amp_guard(True):
        card, _ = fc.run(op_type, case[1], case[2], case[3], cuda)
        cpu, _ = fc.run(op_type, case[1], case[2], case[3], "cpu")
    a, b = card["output_out0"].cpu(), cpu["output_out0"]
    assert a.dtype == b.dtype == (torch.bfloat16 if op_type ==
                                  "conv2d_transpose" else torch.float32)
    assert float((a.float() - b.float()).abs().max()) <= \
        BF16_TOL * float(b.float().abs().max())


def test_pose_full_width_captured_bit_equal_eager_on_card(cuda,
                                                          monkeypatch):
    """chip_smoke's SimpleBaseline at full width (ResNet-50, three
    deconvolutions, 17 heatmaps at 64x48 of a 256x192 input) with Adam at
    B=4: three runs of one batch through the plan cache (eager, the
    capture, a replay) bit-equal to the same runs eager in deterministic
    mode, no block kept eager, one fused_adam launch a step."""
    import chip_smoke as cs
    _no_tf32(monkeypatch)
    pt.framework.unique_name.reset()
    main, startup, loss, heat = cs.pose_train(pt)
    assert tuple(heat.shape[1:]) == (17, 64, 48)
    feed = cs._pose_batch(torch, 0, cuda, B=4)
    kreg.reset_counts()
    runs = _cached_against_eager(main, startup, [feed] * 3, [loss, heat],
                                 monkeypatch)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 2)
    # each way: three steps, one launch each (the capture counts its run)
    assert kreg.launches()["fused_adam"] == 6
    out = runs[True][0][0]
    assert np.isfinite(out[0]).all() and out[1].shape == (4, 17, 64, 48)


@pytest.mark.parametrize("size", ["OutSize", "list"])
def test_resize_size_and_the_capture_on_card(cuda, size):
    """A resize whose size is an OutSize input reads it on the host: its
    block runs eagerly on the card with bilinear_interp as the reason; to
    a list out_shape it is captured. Both equal the CPU's output."""
    pt.framework.unique_name.reset()
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        img = pt.layers.data("img", [3, 4, 6], dtype="float32")
        if size == "OutSize":
            shape = pt.layers.data("shape", [2], dtype="int32",
                                   append_batch_size=False)
            out = pt.layers.resize_bilinear(img, actual_shape=shape)
        else:
            out = pt.layers.resize_bilinear(img, out_shape=[8, 9])
    feed = {"img": np.random.default_rng(0).standard_normal(
        (2, 3, 4, 6)).astype(np.float32)}
    if size == "OutSize":
        feed["shape"] = np.array([8, 9], np.int32)
    want = np.asarray(pt.Executor(pt.CPUPlace()).run(
        main, feed=feed, fetch_list=[out], scope=pt.Scope())[0])
    exe, scope = pt.Executor(), pt.Scope()
    for _ in range(3):
        got = np.asarray(exe.run(main, feed=feed, fetch_list=[out],
                                 scope=scope)[0])
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    c = exe._engine.counters
    if size == "OutSize":
        assert set(exe._engine.eager_reasons.values()) == \
            {"bilinear_interp"} and c["captures"] == 0
    else:
        assert not exe._engine.eager_reasons and c["captures"] == 1


def _detection_cases_on_card(cases, cuda):
    """Each case through its lowering on the card and on the CPU (LoDs
    equal), and its `<op>_grad` lowering under one random cotangent of
    every float output: float32 within F32_TOL forward, BWD_F32_TOL
    backward, the rest exact."""
    from paddle_tpu_torch.ops import family_cases as fc
    rng = np.random.default_rng(6)
    for op_type, ins, lods, attrs, outs, diff in cases:
        card, clod = fc.run(op_type, ins, attrs, outs, cuda, lods)
        cpu, plod = fc.run(op_type, ins, attrs, outs, "cpu", lods)
        for n, v in card.items():
            a, b = v.cpu(), cpu[n]
            assert a.dtype == b.dtype and a.shape == b.shape, (op_type, n)
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)
            else:
                assert torch.equal(a, b), (op_type, n)
            assert clod[n] == plod[n], (op_type, n)
        if not diff:
            continue
        g_ins = dict(ins)
        for slot, count in outs.items():
            v = cpu[f"{slot.lower()}_out0"]
            if count == 1 and v.is_floating_point():
                g_ins[slot] = v.numpy()
                g_ins[slot + "@GRAD"] = rng.standard_normal(
                    tuple(v.shape)).astype(np.float32)
        g_outs = {s + "@GRAD": 1 for s in diff}
        gcard, _ = fc.run(op_type + "_grad", g_ins, attrs, g_outs, cuda,
                          lods)
        gcpu, _ = fc.run(op_type + "_grad", g_ins, attrs, g_outs, "cpu",
                         lods)
        for n, v in gcard.items():
            torch.testing.assert_close(v.cpu(), gcpu[n], rtol=BWD_F32_TOL,
                                       atol=BWD_F32_TOL)


def test_one_stage_ops_on_card_equal_the_cpu(cuda, monkeypatch):
    """Every case of ops/family_cases.py's one_stage_cases() on the card
    against the CPU (_detection_cases_on_card)."""
    from paddle_tpu_torch.ops import family_cases as fc
    _no_tf32(monkeypatch)
    _detection_cases_on_card(fc.one_stage_cases(), cuda)


def test_two_stage_ops_on_card_equal_the_cpu(cuda, monkeypatch):
    """Every case of ops/family_cases.py's two_stage_cases() (the RoI
    poolings with their gradients, proposals, the sampling ops with
    use_random=False, mask targets, FPN routing) on the card against
    the CPU (_detection_cases_on_card): roi_pool's Argmax and every
    sampled index exactly."""
    from paddle_tpu_torch.ops import family_cases as fc
    _no_tf32(monkeypatch)
    _detection_cases_on_card(fc.two_stage_cases(), cuda)


def test_roi_align_backward_is_deterministic_on_card(cuda, monkeypatch):
    """roi_align's gradient (an accumulate of the taps' rows) at 256 RoIs
    of 14x14 on a [2, 64, 50, 84] map: two calls bit-equal in
    deterministic mode, and within BWD_F32_TOL of the CPU's."""
    from paddle_tpu_torch.ops import family_cases as fc
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 64, 50, 84)).astype(np.float32)
    xy = rng.uniform(0, 1000, (256, 2))
    rois = np.concatenate([xy, xy + rng.uniform(16, 400, (256, 2))],
                          1).astype(np.float32)
    attrs = {"pooled_height": 14, "pooled_width": 14,
             "spatial_scale": 1.0 / 16, "sampling_ratio": 0}
    ins = {"X": x, "ROIs": rois,
           "Out": np.zeros((256, 64, 14, 14), np.float32),
           "Out@GRAD": rng.standard_normal((256, 64, 14, 14)).astype(
               np.float32)}
    lods = {"rois": [[0, 128, 256]]}
    old = _deterministic(monkeypatch)
    try:
        got = [fc.run("roi_align_grad", ins, attrs, {"X@GRAD": 1}, cuda,
                      lods)[0]["x@grad_out0"].cpu() for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])
    assert torch.equal(got[0], got[1])
    cpu = fc.run("roi_align_grad", ins, attrs, {"X@GRAD": 1}, "cpu",
                 lods)[0]["x@grad_out0"]
    torch.testing.assert_close(got[0], cpu, rtol=BWD_F32_TOL,
                               atol=BWD_F32_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_out_of_range_on_card(cuda, dtype):
    """gather at [-1, -n, n, 0] on the card: no device assert, the rows
    the CPU gives (the fill value for n), and the gradient: the wrapped
    rows receive theirs, the filled row sends none."""
    from paddle_tpu_torch.ops import family_cases as fc
    x = (np.arange(12).reshape(4, 3) * 1.5).astype(dtype)
    ins = {"X": x, "Index": np.array([-1, -4, 4, 0], np.int32)}
    card, _ = fc.run("gather", ins, {}, {"Out": 1}, cuda)
    cpu, _ = fc.run("gather", ins, {}, {"Out": 1}, "cpu")
    torch.testing.assert_close(card["out_out0"].cpu(), cpu["out_out0"],
                               equal_nan=True, rtol=0, atol=0)
    if dtype is np.float32:
        g = dict(ins, Out=cpu["out_out0"].numpy(),
                 **{"Out@GRAD": np.ones((4, 3), np.float32)})
        gc, _ = fc.run("gather_grad", g, {}, {"X@GRAD": 1}, cuda)
        np.testing.assert_array_equal(gc["x@grad_out0"].cpu().numpy(),
                                      [[2] * 3, [0] * 3, [0] * 3, [1] * 3])


def test_top_k_input_keeps_its_block_eager_on_card(cuda):
    """top_k with a K input reads it on the host: its block runs eagerly
    on the card with top_k as the reason, equal to the CPU's output."""
    pt.framework.unique_name.reset()
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.layers.data("x", [7], dtype="float32")
        k = pt.layers.data("k", [1], dtype="int32", append_batch_size=False)
        vals = main.global_block().create_var(name="vals", dtype="float32")
        ids = main.global_block().create_var(name="ids", dtype="int64")
        main.global_block().append_op(
            "top_k", inputs={"X": x, "K": k},
            outputs={"Out": vals, "Indices": ids}, attrs={"k": 1},
            infer_shape=False)
    feed = {"x": np.random.default_rng(0).standard_normal(
        (3, 7)).astype(np.float32), "k": np.array([4], np.int32)}
    want = pt.Executor(pt.CPUPlace()).run(main, feed=feed,
                                          fetch_list=[vals],
                                          scope=pt.Scope())[0]
    exe, scope = pt.Executor(), pt.Scope()
    for _ in range(3):
        got = exe.run(main, feed=feed, fetch_list=[vals], scope=scope)[0]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert set(exe._engine.eager_reasons.values()) == {"top_k"}
    assert exe._engine.counters["captures"] == 0
    assert np.asarray(want).shape == (3, 4)


def test_yolov3_full_width_captured_bit_equal_eager_on_card(cuda,
                                                            monkeypatch):
    """chip_smoke's YOLOv3 at full width and depth (DarkNet-53, three
    heads, 80 classes, 608x608) with Momentum under the warm-up schedule
    and L2Decay at B=2: three runs of one COCO-shaped batch through the
    plan cache (eager, the capture, a replay) bit-equal to the same runs
    eager in deterministic mode, no block kept eager."""
    import chip_smoke as cs
    _no_tf32(monkeypatch)
    pt.framework.unique_name.reset()
    main, startup, loss, outs = cs.yolov3_train(pt)
    assert [tuple(o.shape[1:]) for o in outs] == \
        [(255, 19, 19), (255, 38, 38), (255, 76, 76)]
    feed = cs._yolo_train_feed(cs._coco_batch(torch, 0, cuda, B=2))
    runs = _cached_against_eager(main, startup, [feed] * 3, [loss],
                                 monkeypatch)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 2)
    assert all(np.isfinite(o[0]).all() for o in runs[True][0])


def test_retinanet_head_captured_bit_equal_eager_on_card(cuda,
                                                         monkeypatch):
    """chip_smoke's RetinaNet head (two levels, anchor_generator,
    retinanet_target_assign on a LoD of boxes, sigmoid_focal_loss,
    smooth_l1) with SGD at B=4: three runs of one batch through the plan
    cache bit-equal to eager, no block kept eager."""
    import chip_smoke as cs
    _no_tf32(monkeypatch)
    pt.framework.unique_name.reset()
    main, startup, loss, _ = cs.retinanet_train(pt)
    feed = cs._retina_batch(pt, 0, pt.CUDAPlace(0))
    runs = _cached_against_eager(main, startup, [feed] * 3, [loss],
                                 monkeypatch)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 2)


def test_faster_rcnn_full_width_captured_bit_equal_eager_on_card(
        cuda, monkeypatch):
    """chip_smoke's Faster R-CNN at full width and depth (ResNet-50-C4,
    81 classes, the 800x1344 canvas, 12000 / 2000 proposals, 256 anchors
    and 512 RoIs an image, use_random; the frozen affines calibrated,
    rcnn_calibrate) with Momentum under the warm-up schedule and L2Decay
    at B=1: three runs of one COCO-shaped batch
    through the plan cache (eager, the capture, a replay) bit-equal to
    the same runs eager in deterministic mode (the loss, the sampled
    ScoreIndex and RoIs, every persistable), no block kept eager."""
    import chip_smoke as cs
    _no_tf32(monkeypatch)
    pt.framework.unique_name.reset()
    main, startup, outs = cs.faster_rcnn_train(pt)
    block = main.global_block()
    ra = [op for op in block.ops if op.type == "rpn_target_assign"][0]
    fetch = [outs["loss"], block.var(ra.output("ScoreIndex")[0]),
             outs["rois"]]
    feed = cs._rcnn_batch(torch, pt, 0, pt.CUDAPlace(0), B=1)
    init = pt.Scope()
    pt.Executor().run(startup, scope=init)
    cs.rcnn_calibrate(pt, main, init, cs._rcnn_batch(
        torch, pt, cs.RCNN_CALIBRATION_SEED, pt.CUDAPlace(0), B=1),
        pt.CUDAPlace(0))
    runs = _cached_against_eager(main, startup, [feed] * 3, fetch,
                                 monkeypatch, init=init)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons
    # the calibrated scope is copied in: no startup run
    assert (c["captures"], c["replays"], c["eager_runs"]) == (1, 2, 1)
    assert all(np.isfinite(o[0]).all() for o in runs[True][0])
    assert runs[True][0][0][2].shape == (cs.RCNN_ROI_BATCH, 4)


def test_nlp_ops_on_card_equal_the_cpu(cuda):
    """Every case of ops/family_cases.py's nlp_cases() (slice 24's
    eleven ops) on the card against the CPU with its gradient
    (chip_smoke._sweep_nlp: nce's and sample_logits' draws held to the
    numpy reckoning on the card's own samples)."""
    import chip_smoke as cs
    n, types, worst = cs._sweep_nlp(torch, cuda)
    assert len(types) == 11 and worst <= cs.SWEEP_TOL


def test_crnn_ctc_full_width_captured_bit_equal_eager_on_card(
        cuda, monkeypatch):
    """chip_smoke's CRNN-CTC at full width (48x512, 95 classes, GRUs of
    200) at B=4: three runs of one OCR-shaped batch through the plan
    cache (eager, the capture, a replay) bit-equal to the same runs
    eager in deterministic mode (the loss, every persistable), no block
    kept eager."""
    import chip_smoke as cs
    _no_tf32(monkeypatch)
    pt.framework.unique_name.reset()
    main, startup, outs = cs.crnn_ctc_train(pt)
    feed = cs.ocr_batch(torch, pt, 0, pt.CUDAPlace(0), B=4)
    runs = _cached_against_eager(main, startup, [feed] * 3, [outs["loss"]],
                                 monkeypatch)
    _assert_bit_equal(runs)
    _, _, c, reasons = runs[True]
    assert not reasons and (c["captures"], c["replays"]) == (1, 2)
    assert all(np.isfinite(o[0]).all() for o in runs[True][0])


@pytest.mark.parametrize("kind", ["nce custom_dist", "hsigmoid",
                                  "sampled_softmax"])
def test_sampled_heads_captured_bit_equal_eager_on_card(cuda, monkeypatch,
                                                        kind):
    """chip_smoke's sampled heads over 32000 classes at 512 rows: three
    runs through the plan cache bit-equal to eager runs in deterministic
    mode, the draws included."""
    import chip_smoke as cs
    monkeypatch.setitem(cs.HEADS, "rows", 512)
    main, startup, loss = cs._heads_program(pt, kind)
    rng = np.random.default_rng(1)
    feed = {"x": rng.standard_normal((512, 512)).astype(np.float32),
            "label": rng.integers(0, 32000, (512, 1)).astype(np.int64)}
    runs = _cached_against_eager(main, startup, [feed] * 3, [loss],
                                 monkeypatch)
    _assert_bit_equal(runs)
    assert not runs[True][3]


def test_fake_quantize_ops_on_card_equal_the_cpu(cuda):
    """Slice 25's fake-quantize and int8 ops and fsp
    (family_cases.quant_cases) on the card against the CPU, forward:
    equal to the bit (elementwise float32 operations, exact reductions;
    fsp's inputs on a dyadic grid, where its sums are exact in any
    order). Then the gradients of the cases with one
    (family_cases.quant_grad_cases: dyadic inputs, so the gradient a
    scale gathers from the whole tensor is exact in any order) under
    the same cotangents on a grid of 1/4: equal to the bit (the
    straight-through estimator, the clip's tie-splitting gradient
    through the scale, fsp's products)."""
    from paddle_tpu_torch.ops import family_cases as fc
    for op_type, inputs, attrs, outs, _ in fc.quant_cases():
        card, _ = fc.run(op_type, inputs, attrs, outs, cuda)
        cpu, _ = fc.run(op_type, inputs, attrs, outs, "cpu")
        for n, v in card.items():
            assert torch.equal(v.cpu(), cpu[n]), (op_type, n)
    rng = np.random.default_rng(7)
    for op_type, inputs, attrs, outs, diff in fc.quant_grad_cases():
        fwd = {d: fc.run(op_type, inputs, attrs, outs, d)[0]
               for d in (cuda, "cpu")}
        cot = {s: (rng.integers(-4, 5, tuple(fwd["cpu"][
            f"{s.lower()}_out0"].shape)) / 4).astype(np.float32)
               for s in outs if fwd["cpu"][f"{s.lower()}_out0"]
               .is_floating_point()}
        got = {d: fc.run_grad(op_type, inputs, attrs, outs, diff, d, None,
                              fwd[d], cot) for d in (cuda, "cpu")}
        for s in diff:
            assert torch.equal(got[cuda][s].cpu(), got["cpu"][s]), \
                (op_type, s)
            assert got["cpu"][s].abs().max() > 0, (op_type, s)


def test_fsp_on_card_within_its_sum_bound(cuda, monkeypatch):
    """fsp on normal inputs (N=4, 6 and 5 channels, 14x14), forward and
    gradients, the card against the CPU. Out is a sum of K = H * W
    products over H * W, dX a sum over Y's 5 channels and dY over X's 6
    (each of dOut / (H * W) times the other input). In any order a
    K-term float32 sum of rounded products lies within K units of 2^-24
    of the sum of its terms' magnitudes of the exact one, and the
    division and the product with its result round once more: the two
    devices within 2 (K + 2) units of the magnitudes' sum (computed in
    float64 on the CPU) plus 2 units of the value."""
    from paddle_tpu_torch.ops import family_cases as fc
    _no_tf32(monkeypatch)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6, 14, 14)).astype(np.float32)
    y = rng.standard_normal((4, 5, 14, 14)).astype(np.float32)
    g = rng.standard_normal((4, 6, 5)).astype(np.float32)
    ins, outs = {"X": x, "Y": y}, {"Out": 1}
    fwd = {d: fc.run("fsp", ins, {}, outs, d)[0] for d in (cuda, "cpu")}
    grads = {d: fc.run_grad("fsp", ins, {}, outs, ["X", "Y"], d, None,
                            fwd[d], {"Out": g}) for d in (cuda, "cpu")}
    u, hw = 2.0 ** -24, 14 * 14
    ax, ay, ag = (torch.from_numpy(np.abs(a)).double() for a in (x, y, g))
    mags = {"Out": (torch.einsum("nihw,njhw->nij", ax, ay) / hw, hw),
            "X": (torch.einsum("nij,njhw->nihw", ag, ay) / hw, 5),
            "Y": (torch.einsum("nij,nihw->njhw", ag, ax) / hw, 6)}
    vals = {"Out": (fwd[cuda]["out_out0"], fwd["cpu"]["out_out0"]),
            "X": (grads[cuda]["X"], grads["cpu"]["X"]),
            "Y": (grads[cuda]["Y"], grads["cpu"]["Y"])}
    for name, (mag, k) in mags.items():
        a, b = (v.cpu().double() for v in vals[name])
        bound = 2 * (k + 2) * u * mag + 2 * u * b.abs()
        assert ((a - b).abs() <= bound).all(), \
            (name, float(((a - b).abs() / bound).max()))
        assert b.abs().max() > 0


def test_qat_variants_on_card_equal_the_cpu(cuda):
    """chip_smoke's small QAT nets (abs_max weights with range_abs_max and
    abs_max activations; channel-wise weights with moving averages;
    depthwise_conv2d) trained 3 steps on the card, then one forward held
    to the CPU by qat_forward_check."""
    import chip_smoke as cs
    cs._qat_variants(torch, pt, cuda)


def test_random_ops_on_card_follow_their_laws(cuda):
    """chip_smoke._random_stats: the truncated normal (KS), sampling_id
    (chi-square), random_crop's starts, and a block with both replayed
    bit-equal to its eager runs."""
    import chip_smoke as cs
    cs._random_stats(torch, pt, kreg, cuda)
