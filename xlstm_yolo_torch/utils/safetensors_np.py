"""A reader of the safetensors format in numpy, for machines without the
``safetensors`` package.

The format: a little-endian u64 N, then N bytes of JSON mapping each tensor's
name to its ``dtype``, ``shape`` and ``data_offsets`` [begin, end) (counted
from the end of the header; an optional ``__metadata__`` entry holds
strings), then the raw little-endian bytes. Tensors are returned as
copy-on-write memory maps of the file, so a checkpoint larger than the
host's memory is read tensor by tensor as it is copied elsewhere.

The reader takes the dtypes that the JAX package's reader
(``safetensors.safe_open(framework="np")`` in a process that has imported
JAX) takes. There BF16 reads as ``ml_dtypes.bfloat16``, which JAX registers
with numpy; numpy alone has no such type, so this reader widens a BF16
tensor to float32, exactly (its 16 bits are the top half of the float32).
The 8-bit float types are refused there (numpy has no ``float8_*``), and
here with a ValueError naming the tensor and its dtype.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
          "I8": "i1", "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """{name: array} of the safetensors file at ``path``."""
    path = Path(path)
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype = info["dtype"]
        if dtype not in DTYPES and dtype != "BF16":
            raise ValueError(f"{path.name}: tensor {name!r} has dtype {dtype}, which numpy "
                             f"cannot hold (readable: {', '.join(DTYPES)})")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        dt = np.dtype(DTYPES.get(dtype, "<u2"))
        if end - begin != dt.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path.name}: tensor {name!r} of shape {shape} and dtype {dtype} "
                             f"does not fill its {end - begin} bytes")
        if end == begin:
            arr = np.zeros(shape, dt)
        else:
            arr = np.memmap(path, dtype=dt, mode="c", offset=8 + n + begin,
                            shape=shape or (1,)).reshape(shape)
        if dtype == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out
