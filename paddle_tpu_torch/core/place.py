"""Places: which torch device a Program runs on.

Counterpart of paddle_tpu/core/place.py. The accelerator place is
CUDAPlace; it is also the default. A CUDAPlace on a machine without a
visible CUDA device raises when it is resolved: the port never carries
on quietly on the CPU. Pass CPUPlace() to run on the CPU.
"""
from __future__ import annotations

import os

import torch


class Place:
    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        raise NotImplementedError

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"


class CPUPlace(Place):
    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r} needs a CUDA device, and torch sees none. "
                "Pass CPUPlace() to run on the CPU.")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise RuntimeError(
                f"{self!r}: only {n} CUDA device(s) are visible")
        return torch.device("cuda", self.device_id)


class CUDAPinnedPlace(Place):
    """Page-locked host memory: a host place, as the CPU's."""

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


def cpu_places(device_count=None):
    """CPU_NUM (default 1) CPUPlaces, or `device_count`."""
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace(i) for i in range(n)]


def cuda_places(device_ids=None):
    """A CUDAPlace for each of `device_ids`, or for each visible card
    (one where torch sees none: it raises when it is used)."""
    if device_ids is not None:
        return [CUDAPlace(int(i)) for i in device_ids]
    return [CUDAPlace(i) for i in range(max(torch.cuda.device_count(), 1))]


def cuda_pinned_places(device_count=None):
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CUDAPinnedPlace(i) for i in range(n)]


def is_compiled_with_cuda() -> bool:
    """Whether torch was built with CUDA and sees a card."""
    return torch.cuda.is_available()


def default_place() -> Place:
    return CUDAPlace(0)
