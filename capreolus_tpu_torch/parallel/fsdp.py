"""Fully-sharded data parallelism, ZeRO-3 (the JAX package's
``parallel/fsdp.py``).

Every leaf is split over the ``data`` mesh axis along its largest divisible
dimension, so each data device stores only 1 / dp of the weights, of their
gradients and of Adam's moments. The trainer (``trainer/torch_trainer.py``)
makes the schedule explicit: each module's leaves are gathered to a data
shard's device at that module's use (copies of every block, concatenated),
and autograd sends each block's part of the gradient back to the block's
device, where the replicas' parts sum (a reduce-scatter). Adam steps each
block on its own device.
"""

from __future__ import annotations

from capreolus_tpu_torch.parallel.distributed import Mesh, NamedSharding, P, ShardedArray


def fsdp_param_spec(x, dp) -> P:
    """Shard the largest dimension divisible by ``dp``; replicate if none.
    Scalars and leaves with no dimension of at least ``dp`` stay replicated."""
    shape = tuple(getattr(x, "shape", ()))
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[d] >= dp and shape[d] % dp == 0:
            return P(*([None] * d + ["data"]))
    return P()


def shard_params_fsdp(flat, mesh: Mesh):
    """{key: array} -> {key: ShardedArray} with the ZeRO-3 spec over ``data``."""
    dp = mesh.shape["data"]
    return {key: ShardedArray.from_tensor(v, NamedSharding(mesh, fsdp_param_spec(v, dp))) for key, v in flat.items()}
