"""The read side of the JAX package's sharded checkpoints
(``utils/sharded_ckpt.py``): a ``trainer.ckpt=sharded`` directory holds one
raw ``.npy`` per (leaf, unique shard) and a ``manifest.json`` naming each
leaf's flattened key path, global shape and dtype, and each shard file's
global index ranges. ``restore_params`` reassembles such a directory on the
host (numpy, shard files memory-mapped, one leaf at a time) into nested dicts,
or reads a flat flax msgpack file, as the JAX function does; it needs no
device and no second card. A bf16 leaf (stored as its uint16 bits) is widened
to f32 here, exactly: the card's machine has no ``ml_dtypes``.

Writing sharded checkpoints and loading them onto device shardings
(``save_sharded``, ``load_sharded``) belong to multi-device training
(ROADMAP.md item 6, 'Multi-device').
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MANIFEST = "manifest.json"


def is_sharded_checkpoint(path) -> bool:
    return (Path(path) / MANIFEST).exists()


def _assemble_leaf(in_dir: Path, entry) -> np.ndarray:
    """One leaf from its shard files by global index ranges (memory-mapped,
    so peak host memory is one leaf)."""
    dtype = entry["dtype"]
    np_dtype = np.uint16 if dtype == "bfloat16" else np.dtype(dtype)
    full = np.empty(entry["shape"], dtype=np_dtype)
    for sh in entry["shards"]:
        block = np.load(in_dir / sh["file"], mmap_mode="r")
        full[tuple(slice(a, b) for a, b in sh["ranges"])] = block
    if dtype == "bfloat16":  # bf16 bits are the high half of the f32 they widen to
        full = (full.astype(np.uint32) << 16).view(np.float32)
    return full


def restore_nested(in_dir):
    """A dict-only tree (a flax params tree) from a sharded checkpoint, by
    splitting the manifest's flattened key paths."""
    in_dir = Path(in_dir)
    manifest = json.loads((in_dir / MANIFEST).read_text())
    out = {}
    for entry in manifest["leaves"]:
        node = out
        parts = entry["path"].split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = _assemble_leaf(in_dir, entry)
    return out


def restore_params(ckpt_path):
    """A checkpoint's tree, whether flat (flax msgpack file) or sharded (a
    directory with a manifest): the one reader every ``checkpointfile`` goes
    through (``convert.load_params``)."""
    p = Path(ckpt_path)
    if p.is_dir():
        if not is_sharded_checkpoint(p):
            raise ValueError(f"{p} is a directory but not a sharded checkpoint (no {MANIFEST})")
        return restore_nested(p)
    from capreolus_tpu_torch.utils.flax_msgpack import from_bytes

    return from_bytes(p.read_bytes())
