"""The safetensors file format, read and written without the
``safetensors`` package (the machine with the card has none).

Layout: an 8-byte little-endian header length N, then N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`` padded with spaces to a multiple of 8, then the tensors' raw
little-endian bytes back to back (offsets relative to the end of the
header).
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

_DTYPES = {
    torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.float64: "F64", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
}
_FROM_NAME = {v: k for k, v in _DTYPES.items()}


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` (on any device) to ``path``: the header from the
    shapes first, then each tensor's bytes straight from its CPU copy, one
    tensor at a time (no second copy of the bytes, no whole model held
    twice in host memory)."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def load_file(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file onto ``device``."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n])
    body = memoryview(data)[8 + n:]
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        begin, end = spec["data_offsets"]
        dtype = _FROM_NAME[spec["dtype"]]
        if begin == end:
            out[name] = torch.empty(spec["shape"], dtype=dtype, device=device)
            continue
        raw = torch.from_numpy(np.frombuffer(body[begin:end], np.uint8).copy())
        out[name] = raw.view(dtype).reshape(spec["shape"]).to(device)
    return out

