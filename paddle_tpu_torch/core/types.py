"""VarType numbers and their mapping to numpy and torch dtypes.

Counterpart of paddle_tpu/core/types.py. The DataType numbers are the
ones of paddle_tpu/proto/framework.proto, kept here as a plain copy so
the port needs no protobuf package: a Program built by either package
names its dtypes with the same integers.
"""
from __future__ import annotations

import numpy as np
import torch

# framework.proto DataType
DT_BOOL = 1
DT_INT8 = 2
DT_UINT8 = 3
DT_INT16 = 4
DT_INT32 = 5
DT_INT64 = 6
DT_FLOAT16 = 7
DT_BFLOAT16 = 8
DT_FLOAT32 = 9
DT_FLOAT64 = 10

_STR_TO_DT = {
    "bool": DT_BOOL, "int8": DT_INT8, "uint8": DT_UINT8,
    "int16": DT_INT16, "int32": DT_INT32, "int64": DT_INT64,
    "float16": DT_FLOAT16, "bfloat16": DT_BFLOAT16,
    "float32": DT_FLOAT32, "float64": DT_FLOAT64,
}
_DT_TO_STR = {v: k for k, v in _STR_TO_DT.items()}

_DT_TO_TORCH = {
    DT_BOOL: torch.bool, DT_INT8: torch.int8, DT_UINT8: torch.uint8,
    DT_INT16: torch.int16, DT_INT32: torch.int32, DT_INT64: torch.int64,
    DT_FLOAT16: torch.float16, DT_BFLOAT16: torch.bfloat16,
    DT_FLOAT32: torch.float32, DT_FLOAT64: torch.float64,
}
_TORCH_TO_DT = {v: k for k, v in _DT_TO_TORCH.items()}


def convert_dtype(dtype) -> int:
    """Normalize a dtype spec (str, numpy dtype, torch.dtype or a
    DataType number) to the DataType number."""
    if isinstance(dtype, bool):
        raise ValueError(f"unsupported dtype: {dtype!r}")
    if isinstance(dtype, int):
        if dtype not in _DT_TO_STR:
            raise ValueError(f"unsupported DataType number: {dtype}")
        return dtype
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_DT:
            raise ValueError(f"unsupported dtype: {dtype!r}")
        return _TORCH_TO_DT[dtype]
    if isinstance(dtype, str):
        if dtype not in _STR_TO_DT:
            raise ValueError(f"unsupported dtype string: {dtype!r}")
        return _STR_TO_DT[dtype]
    name = np.dtype(dtype).name
    if name not in _STR_TO_DT:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _STR_TO_DT[name]


def dtype_to_str(dtype) -> str:
    return _DT_TO_STR[convert_dtype(dtype)]


def dtype_to_torch(dtype) -> torch.dtype:
    return _DT_TO_TORCH[convert_dtype(dtype)]


def dtype_to_np(dtype) -> np.dtype:
    """numpy dtype of a DataType. numpy has no bfloat16: a bf16 value
    crosses to the host as float32."""
    dt = convert_dtype(dtype)
    if dt == DT_BFLOAT16:
        return np.dtype("float32")
    return np.dtype(_DT_TO_STR[dt])

