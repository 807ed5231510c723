"""Entry points of paddle_tpu_torch that take an optional device or
place run on the card when none is given (the default place,
CUDAPlace(0)), and raise, naming CPUPlace(), where torch sees no card:
they never fall back to the CPU. An explicit CPU device or place keeps
working on the CPU.

The no-card checks skip where a card is present; the explicit-CPU ones
run everywhere.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.core.scope import LoDTensor
from paddle_tpu_torch.kernels import flash_attention as FA
from paddle_tpu_torch.kernels import parity
from paddle_tpu_torch.tuning import variants as V
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA device: the default place is real")


def test_search_variants_without_a_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        V.search_variants(256, 256, 256)
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        V.verify_variant(V.Variant(64, 64, 16, "none"))


def test_search_variants_takes_the_cpu_only_when_asked():
    for dev in ("cpu", torch.device("cpu")):
        res = V.verify_variant(V.Variant(64, 64, 16, "none"), 64, 64, 64,
                               device=dev)
        assert res["passed"]


def test_lodtensor_set_without_a_place_raises_without_a_card(no_card):
    t = LoDTensor()
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        t.set(np.ones((2, 3), np.float32))
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        t.set(torch.ones(2, 3))
    assert t.tensor is None


def test_lodtensor_set_on_the_cpu_place():
    t = LoDTensor()
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t.set(a, pt.CPUPlace())
    assert t.tensor.device.type == "cpu"
    np.testing.assert_array_equal(np.asarray(t), a)
    t.set(torch.ones(4), pt.CPUPlace())
    assert t.tensor.device.type == "cpu" and t.shape() == (4,)


def _sgd_case():
    case, = [c for c in parity.cases() if c.label.startswith("fused_sgd")
             and c.label.endswith("(2048,)")]
    return case


def test_run_case_without_a_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        parity.run_case(_sgd_case())


def test_run_case_takes_the_cpu_only_when_asked():
    for dev in ("cpu", torch.device("cpu")):
        assert parity.run_case(_sgd_case(), dev)["passed"]


def test_dropout_keep_mask_without_a_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        FA.dropout_keep_mask(1, 2, 1, 2, 4, 4, 230)


def test_dropout_keep_mask_takes_the_cpu_only_when_asked():
    for dev in ("cpu", torch.device("cpu")):
        keep = FA.dropout_keep_mask(1, 2, 1, 2, 4, 4, 230, dev)
        assert keep.device.type == "cpu" and keep.shape == (1, 2, 4, 4)


def test_dense_target_feed_without_a_place_raises_without_a_card(no_card):
    from paddle_tpu_torch.models import machine_translation as mt
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        mt.dense_target_feed(np.random.default_rng(0), 2, 50, 4)


def test_dense_target_feed_takes_the_cpu_only_when_asked():
    from paddle_tpu_torch.models import machine_translation as mt
    dense, lod = mt.dense_target_feed(np.random.default_rng(0), 3, 50, 4,
                                      pt.CPUPlace(), median=4.0)
    assert dense["tgt_in"].shape == (3, 4)
    assert lod["tgt_lab"].tensor.device.type == "cpu"
    assert lod["tgt_lab"].lod() == [[0, 4, 8, 12]]
