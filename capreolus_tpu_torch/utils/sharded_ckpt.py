"""Sharded, optionally asynchronous checkpoints (the JAX package's
``utils/sharded_ckpt.py``), in the JAX package's directory format:

- ``save_sharded`` writes one raw ``.npy`` per (leaf, unique shard) and a
  ``manifest.json`` naming each leaf's flattened key path ("a/b/0"), global
  shape and dtype, and each shard file's global index ranges, into a tmp
  directory renamed into place, then a ``done`` file. A tensor leaf is one
  shard (``<leaf>_000_p0.npy``, its full range); a ``ShardedArray`` leaf (a
  trainer's mesh placement) is one slab per distinct block, named by its
  position (``<leaf>_<position>_p0.npy``) with its global ranges, never
  gathered to one device, as JAX writes its addressable shards. Any layout
  of either package's ``load_sharded`` reassembles both. A bf16 leaf is
  stored as its uint16 bits, the manifest keeping the name ``bfloat16``, as
  JAX stores it. Leaves are numpy arrays, torch tensors (on any device) or
  Python scalars; dicts flatten in sorted key order and lists / tuples by
  position, as ``jax.tree_util`` flattens them.
- ``load_sharded`` reassembles each leaf by global index ranges (shard files
  memory-mapped, one leaf at a time), whatever layout wrote them, onto the
  host (numpy) or one ``device`` (torch tensors); with ``like`` it rebuilds
  that tree's structure and checks every leaf path, without it the nested
  dicts of the manifest's paths; with ``shardings`` each leaf lands on its
  target ``NamedSharding`` as a ``ShardedArray`` (resharding).
- ``AsyncCheckpointer`` moves the file writes off the training loop:
  ``save_sharded(..., async_checkpointer=ac)`` snapshots every leaf to the
  host first (every device-to-host copy started before one wait), then a
  daemon thread writes; each write waits for the one before it, ``after``
  chains a callable (the trainer's ``.done``) behind them, and ``wait``
  joins and re-raises a failed write.

``restore_params`` reads a flat flax msgpack file or a sharded directory
(bf16 leaves widened to f32, exactly: the card's machine has no
``ml_dtypes``), the one reader every ``checkpointfile`` goes through.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

MANIFEST = "manifest.json"
DONE = "done"


def _flatten(tree, path=()):
    """[(key path, leaf)] in ``jax.tree_util``'s order: dict keys sorted,
    sequences by position."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in _flatten(v, path + (str(i),))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in ``_flatten``'s order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}  # the template's key order; the leaves come in sorted order
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _snapshot_tree(tree):
    """Every leaf of ``tree`` copied to a host numpy array: ([manifest
    entries], {filename: array}). Device-to-host copies of CUDA tensors are
    all started before one synchronisation; host leaves are copied, so the
    caller may change its tensors as soon as this returns."""
    from capreolus_tpu_torch.parallel.distributed import ShardedArray

    entries, pending, cuda = [], [], set()
    for li, (path, leaf) in enumerate(_flatten(tree)):
        fn = f"{li:05d}_000_p0.npy"
        if isinstance(leaf, ShardedArray):  # one slab per distinct block, never the gathered leaf
            shards = []
            for si, (_, index, replica, block) in enumerate(leaf.addressable_shards):
                if replica != 0:
                    continue
                fn = f"{li:05d}_{si:03d}_p0.npy"
                t, dtype = _host_copy(block, cuda)
                shards.append({"file": fn, "ranges": [list(r) for r in index]})
                pending.append((fn, t, dtype == "bfloat16"))
            entries.append({"path": "/".join(path), "shape": list(leaf.shape), "dtype": dtype, "shards": shards})
            continue
        if isinstance(leaf, torch.Tensor):
            host, dtype = _host_copy(leaf, cuda)
        else:
            host = np.array(leaf)  # a copy
            dtype = str(host.dtype)
        shape = list(host.shape)
        entries.append({"path": "/".join(path), "shape": shape, "dtype": dtype,
                        "shards": [{"file": fn, "ranges": [(0, d) for d in shape]}]})
        pending.append((fn, host, dtype == "bfloat16"))
    for dev in cuda:
        torch.cuda.synchronize(dev)
    blocks = {}
    for fn, host, bf16 in pending:
        a = host.numpy() if isinstance(host, torch.Tensor) else host
        blocks[fn] = a.view(np.uint16) if bf16 else a
    return entries, blocks


def _host_copy(tensor, cuda):
    """(a host copy of ``tensor``, its dtype's name): bf16 as its int16 bits,
    a CUDA tensor's copy started without a wait (its device added to ``cuda``)."""
    t = tensor.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)  # the bits; the manifest keeps the dtype's name
        dtype = "bfloat16"
    else:
        dtype = str(t.dtype).replace("torch.", "")
    if t.device.type == "cuda":
        cuda.add(t.device)
        return t.to("cpu", non_blocking=True), dtype
    return t.clone(), dtype


def _write_blocks(out_dir: Path, manifest_leaves, blocks, finalize: bool = True):
    """The file half of a save (on the writer thread when asynchronous): the
    shard files and the manifest into ``<out_dir>.tmp``, renamed to
    ``out_dir``, then its ``done`` file."""
    out_dir = Path(out_dir)
    tmp = out_dir.parent / (out_dir.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    for fn, a in blocks.items():
        np.save(tmp / fn, a)
    (tmp / MANIFEST).write_text(json.dumps({"leaves": manifest_leaves}))
    if finalize:
        if out_dir.exists():
            shutil.rmtree(out_dir)
        tmp.rename(out_dir)
        (out_dir / DONE).write_text("done")


def save_sharded(out_dir, tree, async_checkpointer=None):
    """Write ``tree`` as a sharded checkpoint directory. With
    ``async_checkpointer`` the host snapshot is taken now and the files are
    written on its thread; otherwise the write is synchronous. Returns the
    bytes of the leaves' data."""
    manifest_leaves, blocks = _snapshot_tree(tree)
    if async_checkpointer is not None:
        async_checkpointer._submit(Path(out_dir), manifest_leaves, blocks, True)
    else:
        _write_blocks(Path(out_dir), manifest_leaves, blocks, True)
    return sum(a.nbytes for a in blocks.values())


def is_sharded_checkpoint(path) -> bool:
    return (Path(path) / MANIFEST).exists()


def _assemble_leaf(in_dir: Path, entry) -> np.ndarray:
    """One leaf from its shard files by global index ranges (memory-mapped,
    so peak host memory is one leaf). bf16 widens to f32."""
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


def load_sharded(in_dir, like=None, device=None, shardings=None):
    """Reassemble a sharded checkpoint written by either package under any
    layout: numpy leaves on the host, or torch tensors on ``device``. With
    ``like`` (a tree of the saved structure) its structure comes back and
    every leaf path must match the manifest's; a template leaf that is a bf16
    tensor gets its bf16 back. ``shardings`` (a tree of ``like``'s structure
    of ``NamedSharding``s, or None per leaf) places each leaf on its target
    layout as a ``ShardedArray``: assembly is by global index ranges, so a
    checkpoint written under one layout loads onto any other."""
    from capreolus_tpu_torch.parallel.distributed import ShardedArray

    in_dir = Path(in_dir)
    manifest = json.loads((in_dir / MANIFEST).read_text())
    targets = [s for _, s in _flatten(shardings)] if shardings is not None else None

    def place(arr, tmpl=None, target=None):
        if target is not None:
            return ShardedArray.from_tensor(np.ascontiguousarray(arr), target)
        if device is None:
            return arr
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        return t.to(tmpl.dtype) if isinstance(tmpl, torch.Tensor) and tmpl.dtype == torch.bfloat16 else t

    if like is None:
        tree = restore_nested(in_dir)
        return _unflatten(tree, [place(a) for _, a in _flatten(tree)]) if device is not None else tree
    leaves = _flatten(like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"sharded checkpoint {in_dir} has {len(manifest['leaves'])} leaves; "
                         f"the template tree has {len(leaves)}")
    out = []
    for li, ((path, tmpl), entry) in enumerate(zip(leaves, manifest["leaves"])):
        if "/".join(path) != entry["path"]:
            raise ValueError(f"checkpoint leaf order mismatch: template {'/'.join(path)!r} "
                             f"vs saved {entry['path']!r}")
        out.append(place(_assemble_leaf(in_dir, entry), tmpl, targets[li] if targets is not None else None))
    return _unflatten(like, out)


class AsyncCheckpointer:
    """Serializes checkpoint writes onto daemon threads, one after another:
    ``save_sharded(..., async_checkpointer=ac)`` returns once the host
    snapshot is taken; each write joins the one before it, so directories
    never interleave and ``after`` hooks run once every earlier write is on
    disk. ``wait`` joins and re-raises a write's failure."""

    def __init__(self):
        self._thread = None
        self._error = None

    def _enqueue(self, fn, what):
        prev = self._thread

        def run():
            if prev is not None:
                prev.join()
            if self._error is not None:
                return  # an earlier write in this chain failed: finalize nothing
            try:
                fn()
            except Exception as e:  # surfaced on the next wait()
                self._error = e
                logger.error("async checkpoint write (%s) failed: %s", what, e)

        t = threading.Thread(target=run, name="ckpt-writer", daemon=True)
        self._thread = t
        t.start()

    def _submit(self, out_dir, manifest_leaves, blocks, finalize):
        self._enqueue(lambda: _write_blocks(out_dir, manifest_leaves, blocks, finalize), str(out_dir))

    def after(self, fn):
        """Run ``fn`` on the writer thread once every write submitted before
        it has completed (the trainer's ``.done``, which must cover the
        params and the optimizer trees)."""
        self._enqueue(fn, "after-hook")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
