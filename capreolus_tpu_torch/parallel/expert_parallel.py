"""Expert parallelism (the JAX package's ``parallel/expert_parallel.py``):
MoE expert weights split over an ``expert`` mesh axis.

The expert-stacked leaves of ``MoeFFN`` (``experts_wi`` [E, H, I], ...) carry a
leading [E] axis; ``shard_params_ep`` places that axis over ``expert``, so
expert position j holds experts j * E / ep onwards. ``ep_moe`` computes the
gate on the data shard's first device, each expert's FFN on its owner device
(the tokens copied there), and sums the gated outputs back on the first
device in expert order, as ``MoeFFN`` sums them. Everything else is
replicated over ``expert``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from capreolus_tpu_torch.parallel.distributed import Mesh, NamedSharding, P, ShardedArray
from capreolus_tpu_torch.parallel.tensor_parallel import moe_gates, path_name

# (path-suffix, spec): expert-stacked leaves shard their leading [E] axis
_RULES = (
    ("experts_wi", P("expert", None, None)),
    ("experts_wo", P("expert", None, None)),
    ("experts_bi", P("expert", None)),
    ("experts_bo", P("expert", None)),
)


def expert_param_spec(path) -> P:
    name = path_name(path)
    for suffix, spec in _RULES:
        if name.endswith(suffix):
            return spec
    return P()  # gate, attention, embeddings, heads: replicated


def make_ep_mesh(devices=None, ep=2):
    """2D (data, expert) mesh; the data axis gets the remaining devices."""
    from capreolus_tpu_torch.parallel.distributed import visible_devices

    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    if len(devices) % ep != 0:
        raise ValueError(f"{len(devices)} devices not divisible by ep={ep}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(len(devices) // ep, ep), ("data", "expert"))


def ep_spec(path, shape, ep):
    """``expert_param_spec``, replicated where the expert dim does not divide ``ep``."""
    spec = expert_param_spec(path)
    for dim, axis in enumerate(spec):
        if axis == "expert" and (len(shape) <= dim or shape[dim] % ep != 0):
            return P()
    return spec


def shard_params_ep(flat, mesh: Mesh):
    """{key: array} -> {key: ShardedArray} with expert-axis specs."""
    ep = mesh.shape["expert"]
    return {key: ShardedArray.from_tensor(v, NamedSharding(mesh, ep_spec(key, tuple(v.shape), ep)))
            for key, v in flat.items()}


def ep_moe(config, get, x, devices):
    """``MoeFFN`` over the expert devices ``devices`` of one data shard:
    ``get(name, j)`` is leaf ``name`` ("experts_wi", "gate/kernel", ...) as
    expert position j holds it, on ``devices[j]``; ``x`` [B, L, H] is on
    ``devices[0]``. Returns [B, L, H] there."""
    ep = len(devices)
    e_count = config.moe_experts
    approximate = "tanh" if config.gelu_approximate else "none"
    gates = moe_gates(config, get("gate/kernel", 0), get("gate/bias", 0), x)
    local = get("experts_wi", 0).shape[0]  # experts per position (all of them when replicated)
    held = {}
    out = None
    for e in range(e_count):
        j, i = (e // local, e % local) if local * ep == e_count else (0, e)
        if j not in held:
            held[j] = [get(f"experts_{n}", j) for n in ("wi", "bi", "wo", "bo")]
        wi, bi, wo, bo = held[j]
        xe = x.to(devices[j])
        h = F.gelu(torch.matmul(xe, wi[i]) + bi[i], approximate=approximate)
        y = (gates[..., e:e + 1].to(devices[j]) * (torch.matmul(h, wo[i]) + bo[i])).to(x.device)
        out = y if out is None else out + y
    return out
