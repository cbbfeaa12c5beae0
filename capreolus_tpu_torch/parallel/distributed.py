"""Process-group initialisation and device meshes (the JAX package's
``parallel/distributed.py``).

The JAX package is single-controller: one process holds a ``Mesh`` of
devices with named axes and runs each shard's work on its device. ``Mesh``
here is that object for ``torch.device``s: an array of devices, the axis
names and a ``.shape`` dict. An explicit device list may name one device more
than once: several shards then run on one card (or on the CPU in the tests),
the counterpart of JAX's forced host devices. ``init_distributed`` wraps
``torch.distributed.init_process_group`` for runs of several processes.

The training half states JAX's shardings the same way: ``PartitionSpec``
(``P``) names a mesh axis (or None) per dimension, ``NamedSharding(mesh,
spec)`` gives each mesh position its block's global index ranges as JAX
computes them, and a ``ShardedArray`` is a global array as explicit
per-device tensors, one per distinct block, with ``block`` (a position's
block on its device, copied at use) and ``at`` (the global array gathered on
one device). Every multi-device layout of the port
(``fsdp.py``, ``tensor_parallel.py``, ``expert_parallel.py``,
``pipeline_parallel.py``, ``placement.py``) uses this one representation.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

_initialized = False


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Initialise ``torch.distributed`` (idempotent; a no-op for one process).

    Explicit arguments name the coordinator (``host:port``), the world size
    and this process's rank; otherwise the environment of a launcher
    (``MASTER_ADDR`` with ``WORLD_SIZE``) is read. The backend is NCCL with
    a card and gloo without one."""
    global _initialized
    if _initialized:
        return
    explicit = coordinator_address is not None
    launched = "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ
    if explicit or launched:
        import torch.distributed as dist

        backend = "nccl" if torch.cuda.is_available() else "gloo"
        if explicit:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes), rank=int(process_id))
        else:
            dist.init_process_group(backend, init_method="env://")
        logger.info("torch.distributed initialized: process %d/%d", dist.get_rank(), dist.get_world_size())
    _initialized = True


class Mesh:
    """An array of ``torch.device``s with named axes."""

    def __init__(self, devices, axis_names):
        self.axis_names = tuple(axis_names)
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh of {arr.ndim} dimensions named {self.axis_names}")
        self.devices = arr

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis):
        """The devices along ``axis`` (at position 0 of every other axis)."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(self.devices.shape[i], -1)[:, 0])

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def normalize_device(device):
    """``device`` as a ``torch.device`` with its index: "cuda" is the current CUDA device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def visible_devices():
    """Every visible CUDA device, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: dict, devices=None):
    """A ``Mesh`` from an {axis_name: size} dict; -1 means 'remaining devices'.
    ``devices=None`` takes every visible CUDA device.

    Example: make_mesh({"data": -1}) or make_mesh({"shard": 4}, devices=["cuda:0"] * 4)."""
    devices = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    sizes = dict(axes)
    wildcard = [k for k, v in sizes.items() if v == -1]
    fixed = int(np.prod([v for v in sizes.values() if v != -1])) or 1
    if wildcard:
        if len(wildcard) != 1:
            raise ValueError("only one axis may be -1")
        sizes[wildcard[0]] = len(devices) // fixed
    total = int(np.prod(list(sizes.values())))
    if total > len(devices) or total == 0:
        raise ValueError(f"mesh needs {total} devices, have {len(devices)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(tuple(sizes.values())), tuple(sizes.keys()))


SEARCHER_TOO_FEW = "searcher.shards={shards} but only {have} devices are available"


def shard_devices(shards, devices, message=SEARCHER_TOO_FEW):
    """The first ``shards`` of ``devices`` (``None``: the visible CUDA
    devices); fewer raise ``ValueError`` with ``message`` (the JAX
    searchers' and services' wording). Never a fallback to one device or the
    CPU."""
    available = [torch.device(d) for d in (devices if devices is not None else visible_devices())]
    if len(available) < shards:
        raise ValueError(message.format(shards=shards, have=len(available)))
    return available[:shards]


# ------------------------------------------------------------------ shardings
class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: for each dimension of an array, the mesh axis
    its blocks are spread over, or None (not split); dimensions past its
    length are not split. ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """JAX's ``NamedSharding(mesh, spec)``: the mesh position with coordinate
    ``c`` along axis ``a`` holds block ``c`` of every dimension that ``spec``
    spreads over ``a`` (the dimension cut into ``mesh.shape[a]`` equal
    blocks) and the whole of every other dimension."""

    def __init__(self, mesh: Mesh, spec=P()):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        for axis in self.spec:
            if axis is not None and axis not in mesh.axis_names:
                raise ValueError(f"{self.spec} names axis {axis!r}; the mesh has {mesh.axis_names}")

    def positions(self):
        """Every mesh position (a coordinate tuple), in row-major order: the
        order of a JAX array's ``addressable_shards`` on a mesh built from
        ``jax.devices()``."""
        return list(np.ndindex(*self.mesh.devices.shape))

    def index(self, pos, shape):
        """The global index ranges [(start, stop)] of position ``pos``'s block."""
        out = []
        for dim, size in enumerate(shape):
            axis = self.spec[dim] if dim < len(self.spec) else None
            if axis is None:
                out.append((0, int(size)))
                continue
            n = self.mesh.shape[axis]
            if size % n:
                raise ValueError(f"dimension {dim} of size {size} does not divide over {axis}={n}")
            c = pos[self.mesh.axis_names.index(axis)]
            out.append((c * size // n, (c + 1) * size // n))
        return tuple(out)

    def shards(self, shape):
        """[(position, device, index ranges, replica_id)] of every mesh
        position: ``replica_id`` counts the earlier positions that hold the
        same block, as JAX numbers a block's copies."""
        seen, out = {}, []
        for pos in self.positions():
            index = self.index(pos, shape)
            out.append((pos, self.mesh.devices[pos], index, seen.get(index, 0)))
            seen[index] = seen.get(index, 0) + 1
        return out

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


def _slices(index):
    return tuple(slice(a, b) for a, b in index)


def assemble_blocks(blocks, device=None):
    """The global tensor of [(index ranges, tensor)] blocks that tile it, on
    ``device`` (the first block's by default): the blocks concatenated along
    every split dimension, so the result is differentiable in each block."""
    device = torch.device(device) if device is not None else blocks[0][1].device
    if len(blocks) == 1:
        return blocks[0][1].to(device)
    split = [d for d in range(len(blocks[0][0])) if len({b[0][d] for b in blocks}) > 1]

    def cat(group, dims):
        if not dims:
            return group[0][1].to(device)
        d = dims[0]
        starts = sorted({b[0][d][0] for b in group})
        return torch.cat([cat([b for b in group if b[0][d][0] == s], dims[1:]) for s in starts], dim=d)

    return cat(blocks, split)


class ShardedArray:
    """A global array as explicit per-device tensors: one tensor per distinct
    block (its ``replica_id`` 0 copy), on the device of the first mesh
    position that holds it. Every other position holding that block reads it
    as a copy made at use (``block``), so an optimizer that steps the
    distinct blocks updates every replica, and the copies' gradients sum back
    into the block. ``blocks`` maps index ranges to tensors."""

    def __init__(self, sharding: NamedSharding, shape, blocks: dict):
        self.sharding = sharding
        self.shape = tuple(int(s) for s in shape)
        self.blocks = blocks

    @classmethod
    def from_tensor(cls, value, sharding: NamedSharding, requires_grad=False):
        """``value`` (a tensor or numpy array) cut into ``sharding``'s blocks,
        each placed on its first holder's device (as leaf tensors)."""
        value = torch.as_tensor(np.ascontiguousarray(value)) if not torch.is_tensor(value) else value.detach()
        blocks = {}
        for _, device, index, replica in sharding.shards(value.shape):
            if replica == 0:
                blocks[index] = value[_slices(index)].to(device, copy=True).contiguous() \
                    .requires_grad_(requires_grad)
        return cls(sharding, value.shape, blocks)

    @property
    def dtype(self):
        return next(iter(self.blocks.values())).dtype

    @property
    def spec(self):
        return self.sharding.spec

    def block(self, pos):
        """The block of mesh position ``pos`` on that position's device."""
        mesh = self.sharding.mesh
        return self.blocks[self.sharding.index(pos, self.shape)].to(mesh.devices[pos])

    def at(self, device):
        """The global array on ``device`` (every block copied there and
        concatenated: an all-gather)."""
        return assemble_blocks(list(self.blocks.items()), device)

    @property
    def addressable_shards(self):
        """[(device, index ranges, replica_id, tensor)] of every mesh position,
        in JAX's order; a replica's tensor is its block's (not a copy)."""
        return [(device, index, replica, self.blocks[index])
                for _, device, index, replica in self.sharding.shards(self.shape)]

    def numpy(self):
        return self.at("cpu").detach().float().numpy() if self.dtype == torch.bfloat16 \
            else self.at("cpu").detach().numpy()

    def __repr__(self):
        return f"ShardedArray({self.shape}, {self.sharding})"
