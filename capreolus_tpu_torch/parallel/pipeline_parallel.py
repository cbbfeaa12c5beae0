"""Pipeline parallelism for the BERT encoder (the JAX package's
``parallel/pipeline_parallel.py``): GPipe microbatched stages over a
``pipe`` mesh axis.

The transformer's per-layer parameter trees are stacked along a leading layer
axis (``stack_layer_params``) and placed with that axis split over ``pipe``
(``place_pp_view``): each stage's device holds only its stage's layers. On a 3D
(data, pipe, model) mesh each stacked leaf also carries the Megatron column /
row spec (``tensor_parallel.tp_spec`` past the layer axis), and each stage runs
its layers through ``tensor_parallel.tp_layer`` over its model devices.

``pipelined_layers`` runs the stack as a fill-drain schedule for each data
shard: the shard's batch is cut into M microbatches, and at each of the
``M + S - 1`` ticks every stage whose microbatch is in range (stage s takes
microbatch t - s) applies its layers on its own device(s), in stage order, and
hands its activations to the next stage's devices with a non-blocking copy.
The last stage's outputs are gathered to the data shard's first device.
Autograd runs the backward pipeline through the same copies. The bubble is
(S - 1) / (M + S - 1); ``microbatches=0`` takes the largest divisor of the
per-data-shard batch that is at most 2 * S, as in JAX.

Dropout in a training forward: the embedding output draws once per data shard
(site 0 of the shard's seed), each layer per microbatch, from the shard's seed
folded with ``PP_DROPOUT_SITE``, the microbatch and the layer. The JAX
package's draws differ (its rng), as every port's do.
"""

from __future__ import annotations

import numpy as np
import torch

from capreolus_tpu_torch.convert import flatten_tree, unflatten_tree
from capreolus_tpu_torch.parallel import tensor_parallel as tpmod
from capreolus_tpu_torch.parallel.distributed import Mesh, NamedSharding, P, ShardedArray

PP_DROPOUT_SITE = 0x0E0B


# ------------------------------------------------------------------ param views
def _stack(xs):
    return torch.stack([torch.as_tensor(x) for x in xs]) if any(torch.is_tensor(x) for x in xs) else np.stack(xs)


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_layer_params(bert_params, num_layers):
    """[layer_0 .. layer_{L-1}] subtrees -> one tree with a leading [L] axis."""
    return _map(lambda *xs: _stack(xs), *[bert_params[f"layer_{i}"] for i in range(num_layers)])


def unstack_layer_params(stacked, num_layers):
    """Inverse of stack_layer_params: leading [L] axis -> layer_i subtrees."""
    return {f"layer_{i}": _map(lambda x, i=i: x[i], stacked) for i in range(num_layers)}


def split_bert_params(bert_params, num_layers):
    """(non-layer params, stacked layer params)."""
    rest = {k: v for k, v in bert_params.items() if not k.startswith("layer_")}
    return rest, stack_layer_params(bert_params, num_layers)


def merge_bert_params(rest, stacked, num_layers):
    out = dict(rest)
    out.update(unstack_layer_params(stacked, num_layers))
    return out


def make_pp_mesh(devices=None, pp=2, tp=1):
    """(data, pipe) mesh, or 3D (data, pipe, model) when tp > 1; the data axis
    gets the remaining devices."""
    from capreolus_tpu_torch.parallel.distributed import visible_devices

    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    if len(devices) % (pp * tp) != 0:
        raise ValueError(f"{len(devices)} devices not divisible by pp={pp}*tp={tp}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    if tp > 1:
        return Mesh(arr.reshape(len(devices) // (pp * tp), pp, tp), ("data", "pipe", "model"))
    return Mesh(arr.reshape(len(devices) // pp, pp), ("data", "pipe"))


def stacked_spec(path, shape, mesh: Mesh, num_heads=None):
    """A stacked leaf's spec: ``pipe`` on the layer axis, and on a mesh with a
    ``model`` axis the leaf's Megatron spec past it (replicated over
    ``model`` where that does not divide)."""
    if "model" not in mesh.axis_names:
        return P("pipe")
    spec = tpmod.tp_spec(path, shape, mesh.shape["model"], num_heads, offset=1)
    return P("pipe", *spec)


def place_pp_view(rest, stacked, mesh: Mesh, num_heads=None):
    """Place the split view on the mesh: the stacked layers split over
    ``pipe`` along the layer axis (and Megatron-split over ``model`` on a 3D
    mesh), everything else replicated. Returns trees of ``ShardedArray``s."""
    rep = NamedSharding(mesh, P())
    placed = {k: v if isinstance(v, ShardedArray) else
              ShardedArray.from_tensor(v, NamedSharding(mesh, stacked_spec(k, tuple(v.shape), mesh, num_heads)))
              for k, v in flatten_tree(stacked).items()}
    return (_map(lambda x: x if isinstance(x, ShardedArray) else ShardedArray.from_tensor(x, rep), rest),
            unflatten_tree(placed))


# ------------------------------------------------------------------ embeddings / head
def _leaf(x, device):
    if isinstance(x, ShardedArray):
        return x.at(device)
    return torch.as_tensor(x).to(device)


def embed(config, bert_params, input_ids, token_type_ids=None):
    """``BertEncoder.embed`` of the encoder's flax tree (its non-layer leaves)."""
    flat = flatten_tree(bert_params)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    return tpmod.embed(config, lambda name, d: _leaf(flat[name], d), input_ids, token_type_ids, input_ids.device)


def pool(config, bert_params, hidden):
    flat = flatten_tree(bert_params)
    return tpmod.pool(config, lambda name, d: _leaf(flat[name], d), hidden)


# ------------------------------------------------------------------ the pipeline
def auto_microbatches(b_local, stages):
    """The largest divisor of the per-data-shard batch that is at most 2 * stages."""
    return max(m for m in range(1, max(b_local, 1) + 1) if b_local % m == 0 and m <= 2 * stages)


def gpipe(config, stage_devices, layer, hidden, mask, microbatches, dropout_seed=None):
    """The fill-drain schedule of one data shard. ``stage_devices[s]`` lists
    stage s's model devices; ``layer(s, i, parts, mask, seed)`` applies
    global layer i of stage s to ``parts`` (one tensor per model device).
    ``hidden`` [b, T, H] and ``mask`` [b, T] are on the shard's first
    device; returns the stack's output there."""
    from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

    stages = len(stage_devices)
    per_stage = config.num_layers // stages
    b = hidden.shape[0]
    m_count = int(microbatches) or auto_microbatches(b, stages)
    if b % m_count != 0:
        raise ValueError(f"local batch {b} not divisible by microbatches={m_count}")
    mb = b // m_count
    lead = hidden.device
    xs, masks = hidden.split(mb), mask.split(mb)
    inbox = [dict() for _ in range(stages)]
    inbox[0] = {m: [xs[m].to(d) for d in stage_devices[0]] for m in range(m_count)}
    outputs = [None] * m_count
    for tick in range(m_count + stages - 1):
        for s in range(stages):
            m = tick - s
            if not 0 <= m < m_count:
                continue
            parts = inbox[s].pop(m)
            for i in range(s * per_stage, (s + 1) * per_stage):
                seed = None if dropout_seed is None else dropout_generator_seed(dropout_seed, PP_DROPOUT_SITE, m, i + 1)
                parts = layer(s, i, parts, masks[m], seed)
            if s == stages - 1:
                outputs[m] = parts[0].to(lead, non_blocking=True)
            else:
                inbox[s + 1][m] = [p.to(d, non_blocking=True) for p, d in zip(parts, stage_devices[s + 1])]
    return torch.cat(outputs)


def stage_devices_of(mesh: Mesh, r):
    """Data shard r's devices by stage: [[model devices of stage s], ...]."""
    row = mesh.devices[r]
    return [list(row[s]) if row.ndim > 1 else [row[s]] for s in range(row.shape[0])]


def stage_layer_fn(config, stacked_flat, mesh: Mesh, r, transform=None):
    """``gpipe``'s ``layer`` over a flat {suffix: ShardedArray} stacked tree
    for data shard r: each stage's blocks are copied to the stage's devices
    once per schedule, and passed through ``transform(suffix, block)`` where
    given (the trainer's amp rounding)."""
    per_stage = config.num_layers // mesh.shape["pipe"]
    cache = {}

    def block(suffix, s, j):
        key = (suffix, s, j)
        if key not in cache:
            pos = (r, s, j) if "model" in mesh.axis_names else (r, s)
            value = stacked_flat[suffix].block(pos)
            cache[key] = value if transform is None else transform(suffix, value)
        return cache[key]

    devices = stage_devices_of(mesh, r)

    def layer(s, i, parts, mask, seed):
        get = (lambda suffix, j: block(suffix, s, j)[i - s * per_stage])
        return tpmod.tp_layer(config, get, parts, mask, devices[s], seed)

    return layer


def pipelined_layers(config, stacked_layers, hidden, mask, mesh: Mesh, microbatches, dropout_seed=None):
    """Run the transformer stack as a fill-drain pipeline over ``pipe``, for
    each data shard of ``hidden`` [B, T, H] (its rows cut over ``data``).
    ``stacked_layers`` is the placed stacked tree (``place_pp_view``).
    Returns [B, T, H] on ``hidden``'s device."""
    c = config
    stages = int(mesh.shape["pipe"])
    if c.num_layers % stages != 0:
        raise ValueError(f"num_layers={c.num_layers} not divisible by pipe={stages}")
    dp = int(mesh.shape["data"])
    if hidden.shape[0] % dp:
        raise ValueError(f"batch {hidden.shape[0]} does not divide over data={dp}")
    flat = flatten_tree(stacked_layers)
    rows = hidden.shape[0] // dp
    out = []
    for r in range(dp):
        lead = stage_devices_of(mesh, r)[0][0]
        seed = None if dropout_seed is None else _shard_seed(dropout_seed, r)
        out.append(gpipe(c, stage_devices_of(mesh, r), stage_layer_fn(c, flat, mesh, r),
                         hidden[r * rows:(r + 1) * rows].to(lead), mask[r * rows:(r + 1) * rows].to(lead),
                         microbatches, seed).to(hidden.device))
    return torch.cat(out)


def _shard_seed(seed, r):
    from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

    return dropout_generator_seed(seed, r)


def pipelined_encoder(config, bert_params_rest, stacked_layers, input_ids, attention_mask, token_type_ids,
                      mesh: Mesh, microbatches, dropout_seed=None):
    """Full ``BertEncoder`` forward (embeddings -> pipelined stack -> pooler):
    (sequence_output, pooled_output). Unplaced trees are placed first."""
    from capreolus_tpu_torch.reranker.bert.encoder import dropout

    if not all(isinstance(x, ShardedArray) for x in flatten_tree(stacked_layers).values()):
        bert_params_rest, stacked_layers = place_pp_view(bert_params_rest, stacked_layers, mesh, config.num_heads)
    hidden = embed(config, bert_params_rest, input_ids, token_type_ids)
    hidden = dropout(hidden, config.hidden_dropout_prob, dropout_seed, 0)
    hidden = pipelined_layers(config, stacked_layers, hidden, attention_mask.bool(), mesh, microbatches,
                              dropout_seed=dropout_seed)
    return hidden, pool(config, bert_params_rest, hidden)


# ------------------------------------------------------------------ scorer-level API
def split_scorer_params(scorer_params, config):
    """``_BertScorer``'s flax tree -> the pp view (rest tree, stacked layers).
    The rest tree keeps the scorer's layout minus the per-layer subtrees."""
    tree = scorer_params["params"] if "params" in scorer_params else scorer_params
    rest_bert, stacked = split_bert_params(tree["bert"], config.num_layers)
    rest = {k: v for k, v in tree.items() if k != "bert"}
    rest["bert"] = rest_bert
    return {"params": rest}, stacked


def merge_scorer_params(rest_tree, stacked, config):
    """Inverse of split_scorer_params: pp view -> the scorer's flax tree."""
    tree = rest_tree["params"] if "params" in rest_tree else rest_tree
    bert = merge_bert_params(tree["bert"], stacked, config.num_layers)
    out = {k: v for k, v in tree.items() if k != "bert"}
    out["bert"] = bert
    return {"params": out}


def pipelined_scorer_forward(config, rest_tree, stacked, inp, mask, seg, mesh: Mesh, microbatches,
                             dropout_seed=None):
    """``_BertScorer`` forward through the pipeline: [B, P, L] or [B, L]
    token ids -> [B, P] passage scores."""
    tree = rest_tree["params"] if "params" in rest_tree else rest_tree
    if inp.dim() == 3:
        b, p, length = inp.shape
        inp, mask, seg = inp.reshape(b * p, length), mask.reshape(b * p, length), seg.reshape(b * p, length)
    else:
        b, p = inp.shape[0], 1
    _, pooled = pipelined_encoder(config, tree["bert"], stacked, inp, mask, seg, mesh, microbatches,
                                  dropout_seed=dropout_seed)
    head = tree["classifier"]
    scores = tpmod._linear(pooled.float(), _leaf(head["kernel"], pooled.device), _leaf(head["bias"], pooled.device))
    return scores[:, 0].reshape(b, p)
