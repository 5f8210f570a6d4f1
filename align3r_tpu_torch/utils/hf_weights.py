"""Local Hugging Face model folders without `transformers` (the port's
stand-in for `from_pretrained`, which the JAX loaders call).

A folder holds `config.json` and the weights, as `model.safetensors` or
`pytorch_model.bin`. The safetensors reader is this module's own: an 8-byte
little-endian header length, a JSON header of {name: {dtype, shape,
data_offsets}}, then the raw little-endian F32 / F16 / BF16 / I64 buffers.
A hub name ("org/name") resolves to its snapshot in the local Hugging Face
cache, as an offline `from_pretrained` does; nothing is fetched.

`save_pretrained` writes a folder in the same layout (config.json and
model.safetensors), so a seeded model can be loaded back the way a real
checkpoint is.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "I64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _hub_cache() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache"),
        "huggingface")
    return os.path.join(home, "hub")


def resolve(name_or_path: str) -> str:
    """The local folder of a model: `name_or_path` itself if it is a
    directory, else the snapshot of the hub name in the local cache
    (refs/main, or the only snapshot). Raises FileNotFoundError."""
    if os.path.isdir(name_or_path):
        return name_or_path
    repo = os.path.join(_hub_cache(), "models--" + name_or_path.replace("/", "--"))
    snaps = os.path.join(repo, "snapshots")
    ref = os.path.join(repo, "refs", "main")
    if os.path.isfile(ref):
        with open(ref) as f:
            path = os.path.join(snaps, f.read().strip())
        if os.path.isdir(path):
            return path
    if os.path.isdir(snaps) and len(os.listdir(snaps)) == 1:
        return os.path.join(snaps, os.listdir(snaps)[0])
    raise FileNotFoundError(f"{name_or_path!r} is neither a folder nor a model in the "
                            f"local Hugging Face cache ({_hub_cache()})")


def read_config(folder: str) -> dict:
    with open(os.path.join(folder, "config.json")) as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} from a .safetensors file."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack_from("<Q", raw, 0)
    header = json.loads(raw[8:8 + n])
    header.pop("__metadata__", None)
    base = 8 + n
    out = {}
    for name, meta in header.items():
        dt = _DTYPES.get(meta["dtype"])
        if dt is None:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}, which is not read")
        a, b = meta["data_offsets"]
        buf = bytearray(raw[base + a:base + b])
        t = torch.frombuffer(buf, dtype=dt) if b > a else torch.empty(0, dtype=dt)
        out[name] = t.reshape(meta["shape"])
    return out


def write_safetensors(sd: Dict[str, torch.Tensor], path: str) -> None:
    """Write {name: tensor} as a .safetensors file (contiguous CPU copies)."""
    header, chunks, off = {}, [], 0
    for name in sorted(sd):
        t = sd[name].detach().cpu().contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(data)]}
        chunks.append(data)
        off += len(data)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    hdr += b" " * (-len(hdr) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for c in chunks:
            f.write(c)


def read_state_dict(folder: str) -> Dict[str, torch.Tensor]:
    """The folder's weights: model.safetensors or pytorch_model.bin."""
    st = os.path.join(folder, "model.safetensors")
    if os.path.isfile(st):
        return read_safetensors(st)
    pt = os.path.join(folder, "pytorch_model.bin")
    if os.path.isfile(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {folder}")


def load(name_or_path: str):
    """(config dict, state dict) of a local folder or cached hub model."""
    folder = resolve(name_or_path)
    return read_config(folder), read_state_dict(folder)


def save_pretrained(folder: str, config: dict, state_dict: Dict[str, torch.Tensor]) -> None:
    """A folder that `load` (and transformers' from_pretrained) reads back."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    write_safetensors(state_dict, os.path.join(folder, "model.safetensors"))
