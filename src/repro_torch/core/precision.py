"""Dtype short names, word sizes and accumulator policy, on torch dtypes.

Same short names as the reference (``f32``, ``bf16``, ``fp16``, ``f64``)
so CLI flags, bucket keys and tolerances read alike in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_WORD_BYTES = 4

DTYPES: dict[str, torch.dtype] = {
    "f32": torch.float32,
    "fp16": torch.float16,
    "f64": torch.float64,
    "bf16": torch.bfloat16,
}

_ALIASES = {
    "float32": "f32", "fp32": "f32", "single": "f32",
    "float16": "fp16", "f16": "fp16", "half": "fp16",
    "bfloat16": "bf16",
    "float64": "f64", "fp64": "f64", "double": "f64",
}


def parse_dtype(ref) -> torch.dtype:
    """Resolve a dtype reference (short name, alias, torch or numpy dtype)."""
    if ref is None:
        return DTYPES["f32"]
    if isinstance(ref, torch.dtype):
        return ref
    if isinstance(ref, str):
        name = _ALIASES.get(ref.lower(), ref.lower())
        if name in DTYPES:
            return DTYPES[name]
        raise ValueError(f"unknown dtype {ref!r}; known: {sorted(DTYPES)}")
    name = np.dtype(ref).name
    if name in _ALIASES:
        return DTYPES[_ALIASES[name]]
    raise ValueError(f"unsupported dtype {ref!r}; known: {sorted(DTYPES)}")


def dtype_name(dtype) -> str:
    """Canonical short name of `dtype` (``f32``/``bf16``/``fp16``/``f64``)."""
    dt = parse_dtype(dtype)
    for name, cand in DTYPES.items():
        if cand == dt:
            return name
    return str(dt)


def word_bytes(dtype=None) -> int:
    """Stream word size in bytes of `dtype` (None -> DEFAULT_WORD_BYTES)."""
    if dtype is None:
        return DEFAULT_WORD_BYTES
    return parse_dtype(dtype).itemsize


def finfo(dtype):
    """`torch.finfo` of `dtype` (bfloat16 included)."""
    return torch.finfo(parse_dtype(dtype))


def resolve_acc(stream_dtype, acc="auto"):
    """Accumulator dtype of the MWD in-tile updates for a stream dtype.

    ``"auto"``: float32 accumulation for sub-32-bit streams, native
    otherwise; ``"native"``/None: accumulate in the stream dtype; anything
    `parse_dtype` accepts: that accumulator. Returns the accumulator
    `torch.dtype`, or None when accumulation is native.
    """
    stream = parse_dtype(stream_dtype)
    if acc == "native" or acc is None:
        return None
    if acc == "auto":
        return torch.float32 if stream.itemsize < 4 else None
    a = parse_dtype(acc)
    return None if a == stream else a
