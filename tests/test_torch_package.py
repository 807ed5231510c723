"""Package rules of paddle_tpu_torch: no JAX and no paddle_tpu import in
the package or in chip_smoke.py, no library attention or compiler call in
the package, a CUDA default place that refuses to fall back to the CPU,
and a build directory that git ignores."""
import ast
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as pt

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"


def _sources(with_smoke):
    files = sorted(PKG.rglob("*.py"))
    if with_smoke:
        files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", _sources(True),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_paddle_tpu_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


def test_package_calls_no_library_attention_or_compiler():
    for path in _sources(False):
        # `use_cudnn` is an argument of the fluid layer API (conv2d,
        # pool2d, softmax) that the port accepts and ignores, as the JAX
        # package does
        text = path.read_text().replace("use_cudnn", "")
        for word in ("scaled_dot_product_attention", "torch.compile",
                     "cudnn"):
            assert word not in text, f"{path} mentions {word}"


def test_package_files_are_scanned():
    names = {p.relative_to(PKG).as_posix() for p in _sources(False)}
    assert {"framework.py", "executor.py", "core/engine.py",
            "kernels/flash_attention.py", "ops/fused.py",
            "dygraph/tracer.py", "dygraph/jit.py", "dygraph/nn.py",
            "dygraph/layers.py", "dygraph/base.py",
            "dygraph/checkpoint.py",
            "dygraph/learning_rate_scheduler.py", "ops/quantize.py",
            "layers/distributions.py", "contrib/slim/core/compressor.py",
            "contrib/slim/quantization/quantization_pass.py",
            "contrib/slim/prune/strategies.py",
            "contrib/slim/distillation/strategies.py",
            "contrib/slim/nas/strategies.py"} <= names
    assert (ROOT / "chip_smoke.py").is_file()


def test_default_place_is_cuda():
    assert pt.default_place() == pt.CUDAPlace(0)


def test_executor_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.Executor()
    with pytest.raises(RuntimeError, match="CPUPlace"):
        pt.Executor(pt.CUDAPlace(0))
    assert pt.Executor(pt.CPUPlace()).device == torch.device("cpu")


def test_gitignore_lists_build_dir():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "paddle_tpu_torch/_build/" in lines
