"""Reading a Hugging Face BERT/ELECTRA checkpoint without ``transformers``.

The JAX package reads pretrained weights through ``AutoModel.from_pretrained``,
which finds a local directory or a snapshot in the Hugging Face hub cache. The
port reads the same files with what it has:

- ``find_checkpoint(name)``: ``name`` itself when it is a directory holding
  ``config.json``; else the hub cache's snapshot of that name
  (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
  ``$XDG_CACHE_HOME/huggingface/hub``, else ``~/.cache/huggingface/hub``;
  ``models--<org>--<name>/snapshots/<revision>``, the revision that
  ``refs/main`` names, else the newest). It only reads: nothing is ever
  downloaded.
- ``read_state_dict(directory)``: ``model.safetensors`` through
  ``read_safetensors``, else ``pytorch_model.bin`` through
  ``torch.load(weights_only=True)``.
- ``bert_config(directory)``: the encoder's ``BertConfig`` from
  ``config.json``, built from the same seven fields as the JAX function's.

The safetensors layout is an 8-byte little-endian header length, a JSON
header naming each tensor's dtype, shape and byte offsets (and an optional
``__metadata__``), then the tensors' raw little-endian bytes.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path

import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def hub_cache_dir() -> Path:
    """The Hugging Face hub cache directory, by the environment variables the
    hub library reads."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]) / "hub"
    xdg = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(xdg) / "huggingface" / "hub"


def find_checkpoint(name: str) -> Path:
    """The directory of checkpoint ``name``: a local directory holding
    ``config.json``, or the hub cache's snapshot. Raises FileNotFoundError."""
    local = Path(name)
    if (local / "config.json").is_file():
        return local
    repo = hub_cache_dir() / ("models--" + name.replace("/", "--"))
    snapshots = repo / "snapshots"
    candidates = []
    ref = repo / "refs" / "main"
    if ref.is_file():
        candidates.append(snapshots / ref.read_text().strip())
    if snapshots.is_dir():
        candidates.extend(sorted(snapshots.iterdir(), key=lambda p: p.stat().st_mtime, reverse=True))
    for directory in candidates:
        if (directory / "config.json").is_file():
            return directory
    raise FileNotFoundError(f"no local checkpoint directory {name!r} and no snapshot of it in the hub "
                            f"cache {hub_cache_dir()} (the port never downloads)")


def read_safetensors(path) -> dict:
    """{name: tensor} of a ``.safetensors`` file, tensors on the CPU."""
    data = bytearray(Path(path).read_bytes())
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (header_len,) = struct.unpack("<Q", bytes(data[:8]))
    if 8 + header_len > len(data):
        raise ValueError(f"{path}: header length {header_len} runs past the file's {len(data)} bytes")
    header = json.loads(bytes(data[8:8 + header_len]).decode("utf-8"))
    base = 8 + header_len
    view = memoryview(data)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the reader does not know")
        begin, end = info["data_offsets"]
        shape = list(info["shape"])
        count = 1
        for n in shape:
            count *= n
        size = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * size or base + end > len(data):
            raise ValueError(f"{path}: tensor {name!r} spans bytes {begin}-{end}, not {count} x {size}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(view[base + begin:base + end], dtype=dtype).reshape(shape).clone()
    return out


def read_state_dict(directory) -> dict:
    """The checkpoint's weights: ``model.safetensors``, else ``pytorch_model.bin``."""
    directory = Path(directory)
    if (directory / "model.safetensors").is_file():
        return read_safetensors(directory / "model.safetensors")
    if (directory / "pytorch_model.bin").is_file():
        return torch.load(directory / "pytorch_model.bin", map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"{directory} holds neither model.safetensors nor pytorch_model.bin")


def bert_config(directory):
    """The ``BertConfig`` of the checkpoint's ``config.json``."""
    from capreolus_tpu_torch.reranker.bert.encoder import BertConfig

    cfg = json.loads((Path(directory) / "config.json").read_text(encoding="utf-8"))
    return BertConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                      num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
                      intermediate_size=cfg["intermediate_size"], max_position=cfg["max_position_embeddings"],
                      type_vocab_size=cfg["type_vocab_size"])
