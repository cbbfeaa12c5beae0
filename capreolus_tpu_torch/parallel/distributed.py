"""Process-group initialisation and device meshes (the JAX package's
``parallel/distributed.py``).

The JAX serving paths are single-controller: one process holds a ``Mesh`` of
devices with named axes and runs each shard's work on its device. ``Mesh``
here is that object for ``torch.device``s: an array of devices, the axis
names and a ``.shape`` dict. An explicit device list may name one device more
than once: several shards then run on one card (or on the CPU in the tests),
the counterpart of JAX's forced host devices. ``init_distributed`` wraps
``torch.distributed.init_process_group`` for runs of several processes.
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
