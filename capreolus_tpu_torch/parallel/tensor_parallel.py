"""Tensor parallelism for the BERT encoder (the JAX package's
``parallel/tensor_parallel.py``): Megatron-style column / row sharding over a
``model`` mesh axis.

The JAX package states the layout as parameter shardings and leaves the
collectives to GSPMD. Here the same layout is explicit: ``shard_params_tp``
places every leaf of a flax-keyed parameter tree as a ``ShardedArray`` with
JAX's spec (``bert_param_spec``, the rules ``_RULES``), and ``tp_layer``
runs one encoder layer over the model devices of one data shard. The q / k /
v projections and the FFN's up-projection are column-parallel: model device
j holds H / tp heads' columns and I / tp of the FFN's, and computes its
heads' attention itself (``attention_plain`` under autograd, K2 on CUDA
tensors otherwise). The attention output and the FFN's down-projection are
row-parallel: each device's partial product is summed to every model device
(an all-reduce of copies), then the replicated bias is added.

``sp=True`` is Megatron sequence parallelism: between the products the token
axis is split over the model devices, so the embeddings' LayerNorm, the
residual adds, the LayerNorms and dropout run on 1 / tp of the tokens; the
tokens are gathered before each column-parallel product and the partial
products reduce-scattered after each row-parallel one. The function is the
same as without it.

A leaf whose split dimension does not divide tp stays replicated, as in JAX.
A column split inside a head cannot run attention locally, so the port also
keeps the attention's leaves replicated when the heads do not divide tp
(JAX splits the columns regardless); a layer with replicated attention or
FFN leaves computes that block whole on every model device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from capreolus_tpu_torch.parallel.distributed import Mesh, NamedSharding, P, ShardedArray

# (path-suffix, spec) rules; first match wins. Column-parallel kernels split the
# OUTPUT dim (and their biases), row-parallel kernels split the INPUT dim (their
# biases replicate: they are added after the sum). Specs are of the flax layout.
_RULES = (
    ("attention/query/kernel", P(None, "model")),
    ("attention/key/kernel", P(None, "model")),
    ("attention/value/kernel", P(None, "model")),
    ("attention/query/bias", P("model")),
    ("attention/key/bias", P("model")),
    ("attention/value/bias", P("model")),
    ("attention/output/kernel", P("model", None)),
    ("intermediate/kernel", P(None, "model")),
    ("intermediate/bias", P("model")),
    ("ffn_output/kernel", P("model", None)),
)
_ATTENTION = ("attention/query/", "attention/key/", "attention/value/", "attention/output/")


def path_name(path) -> str:
    """A flax key path as "a/b/c": a string as it is, a tuple of keys joined."""
    if isinstance(path, str):
        return path
    return "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)


def bert_param_spec(path) -> P:
    """JAX's spec of the leaf at ``path`` (a "params/bert/layer_0/..." key)."""
    name = path_name(path)
    for suffix, spec in _RULES:
        if name.endswith(suffix):
            return spec
    return P()  # embeddings, layernorms, pooler, heads: replicated


def make_tp_mesh(devices=None, tp=2):
    """2D (data, model) mesh over ``devices`` (the visible CUDA devices by default)."""
    from capreolus_tpu_torch.parallel.distributed import visible_devices

    devices = [torch.device(d) for d in (visible_devices() if devices is None else devices)]
    if len(devices) % tp != 0:
        raise ValueError(f"{len(devices)} devices not divisible by tp={tp}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(len(devices) // tp, tp), ("data", "model"))


def heads_divide(num_heads, tp) -> bool:
    """Whether each model device can hold whole heads."""
    return num_heads % tp == 0


def tp_spec(path, shape, tp, num_heads=None, offset=0):
    """The spec ``shard_params_tp`` gives the leaf at ``path`` of ``shape``:
    ``bert_param_spec`` past ``offset`` leading dims (a stacked layer axis),
    replicated where a split dim does not divide ``tp`` or, for the
    attention's leaves, where ``num_heads`` does not."""
    spec = bert_param_spec(path)
    name = path_name(path)
    if num_heads is not None and not heads_divide(num_heads, tp) and any(a in name for a in _ATTENTION):
        return P()
    for dim, axis in enumerate(spec):
        if axis == "model" and (len(shape) <= dim + offset or shape[dim + offset] % tp != 0):
            return P()
    return spec


def shard_params_tp(flat, mesh: Mesh, num_heads=None):
    """{key: array} -> {key: ShardedArray} with Megatron column / row specs
    over the mesh's ``model`` axis, replicated over ``data``."""
    tp = mesh.shape["model"]
    return {key: ShardedArray.from_tensor(v, NamedSharding(mesh, tp_spec(key, tuple(v.shape), tp, num_heads)))
            for key, v in flat.items()}


# ------------------------------------------------------------------ the layer
def _linear(x, kernel, bias=None):
    """A flax Dense: ``x @ kernel + bias`` as ``nn.Linear`` computes it."""
    return F.linear(x, kernel.T, bias)


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)


def _dropout(x, rate, seed, site):
    from capreolus_tpu_torch.reranker.bert.encoder import dropout

    return dropout(x, rate, seed, site)


def moe_ffn(config, get, x):
    """``MoeFFN`` of flax leaves ``get(suffix)`` on ``x``'s device (replicated experts)."""
    gates = moe_gates(config, get("moe/gate/kernel"), get("moe/gate/bias"), x)
    approximate = "tanh" if config.gelu_approximate else "none"
    wi, bi, wo, bo = (get(f"moe/experts_{n}") for n in ("wi", "bi", "wo", "bo"))
    out = None
    for e in range(config.moe_experts):
        h = F.gelu(torch.matmul(x, wi[e]) + bi[e], approximate=approximate)
        y = gates[..., e:e + 1] * (torch.matmul(h, wo[e]) + bo[e])
        out = y if out is None else out + y
    return out


def moe_gates(config, kernel, bias, x):
    """[B, L, E] routing weights: top-k of the f32 softmax, renormalised (``MoeFFN.gates``)."""
    probs = torch.softmax(_linear(x.float(), kernel, bias), dim=-1)
    k = min(config.moe_topk, config.moe_experts)
    top = torch.zeros_like(probs).scatter_(-1, probs.topk(k, dim=-1).indices, 1.0)
    gates = probs * top
    return gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)


def tp_layer(config, get, hidden, mask, devices, dropout_seed=None, sp=False):
    """One ``BertLayer`` over the model devices ``devices`` of one data shard.

    ``get(suffix, j)`` is the layer's flax leaf ``suffix`` ("attention/query/
    kernel", ...) as model position j holds it, on ``devices[j]``: its block
    where the leaf is split, else the whole leaf. ``hidden`` is a list with
    one tensor per model device: copies of [B, L, H], or with ``sp`` the
    device's block of L / tp tokens. ``mask`` [B, L] is the key mask.
    ``dropout_seed`` makes it a training forward. Returns the output in
    ``hidden``'s form. With one device this is ``BertLayer.forward``."""
    c = config
    tp = len(devices)
    rate = c.hidden_dropout_prob
    approximate = "tanh" if c.gelu_approximate else "none"
    train = dropout_seed is not None
    blk = hidden[0].shape[1] if sp else None  # tokens per device under sp

    def whole(parts, k):
        """The full sequence on device k (gathered under sp)."""
        return torch.cat([h.to(devices[k]) for h in parts], dim=1) if sp else parts[k]

    def mine(x, k):
        """Device k's part of a full-sequence tensor it holds."""
        return x[:, k * blk:(k + 1) * blk] if sp else x

    def reduce(partials, bias_key):
        """The partial products summed onto every device (an all-reduce), or
        each device's tokens of the sum (a reduce-scatter) under sp; plus the bias."""
        out = []
        for k in range(tp):
            total = None
            for part in partials:
                piece = mine(part, k).to(devices[k])
                total = piece if total is None else total + piece
            out.append(total + get(bias_key, k))
        return out

    def split_heads(x, heads):
        b, length, _ = x.shape
        return x.view(b, length, heads, c.head_dim).transpose(1, 2)

    def attention(x, j, heads, generator):
        """Attention of the heads model position j holds, on the full sequence x."""
        from capreolus_tpu_torch.ops.flash_attention import multihead_attention

        qkv = []
        for name in ("query", "key", "value"):
            y = _linear(x, get(f"attention/{name}/kernel", j), get(f"attention/{name}/bias", j))
            if c.lora_rank > 0 and name in ("query", "value"):
                delta = _linear(_linear(x, get(f"attention/{name}_lora/down/kernel", j)),
                                get(f"attention/{name}_lora/up/kernel", j)) * (c.lora_alpha / c.lora_rank)
                cols = y.shape[-1]
                y = y + (delta if cols == delta.shape[-1] else delta[..., j * cols:(j + 1) * cols])
            qkv.append(split_heads(y, heads))
        m = mask.to(x.device)
        out = multihead_attention(*qkv, m, train=train, dropout_rate=c.attention_dropout_prob, generator=generator)
        b, _, length, _ = out.shape
        return out.transpose(1, 2).reshape(b, length, heads * c.head_dim)

    def generator(k):
        from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator

        if train and c.attention_dropout_prob > 0.0:
            return dropout_generator(dropout_seed, 0, device=devices[k])
        return None

    # attention: heads split over the model devices, or whole on each
    if tp > 1 and heads_divide(c.num_heads, tp) and get("attention/query/kernel", 0).shape[-1] * tp == c.hidden_size:
        partials = [_linear(attention(whole(hidden, j), j, c.num_heads // tp, generator(j)),
                            get("attention/output/kernel", j)) for j in range(tp)]
        attn = reduce(partials, "attention/output/bias")
    else:
        attn = [mine(_linear(attention(whole(hidden, k), k, c.num_heads, generator(k)),
                             get("attention/output/kernel", k), get("attention/output/bias", k)), k)
                for k in range(tp)]
    h = [layer_norm(hidden[k] + _dropout(attn[k], rate, dropout_seed, 1),
                    get("attention_ln/scale", k), get("attention_ln/bias", k), c.layer_norm_eps) for k in range(tp)]

    if c.moe_experts:
        ff = [moe_ffn(c, lambda s, k=k: get(s, k), h[k]) for k in range(tp)]
    elif get("intermediate/kernel", 0).shape[-1] * tp == c.intermediate_size and tp > 1:
        partials = [_linear(F.gelu(_linear(whole(h, j), get("intermediate/kernel", j), get("intermediate/bias", j)),
                                   approximate=approximate), get("ffn_output/kernel", j)) for j in range(tp)]
        ff = reduce(partials, "ffn_output/bias")
    else:
        ff = [_linear(F.gelu(_linear(h[k], get("intermediate/kernel", k), get("intermediate/bias", k)),
                             approximate=approximate), get("ffn_output/kernel", k), get("ffn_output/bias", k))
              for k in range(tp)]
    return [layer_norm(h[k] + _dropout(ff[k], rate, dropout_seed, 2),
                       get("output_ln/scale", k), get("output_ln/bias", k), c.layer_norm_eps) for k in range(tp)]


# ------------------------------------------------------------------ the encoder
def embed(config, get, input_ids, token_type_ids, device, start=0):
    """``BertEncoder.embed`` of flax leaves ``get(name, device)``: the
    embedding sum and its f32 LayerNorm [B, L, H] on ``device``, for tokens
    at positions ``start`` onwards."""
    c = config
    ids, types = input_ids.to(device), token_type_ids.to(device)
    hidden = (get("word_embeddings", device)[ids % c.vocab_size]
              + get("position_embeddings", device)[None, start:start + ids.shape[1]]
              + get("token_type_embeddings", device)[types % c.type_vocab_size])
    return layer_norm(hidden.float(), get("embeddings_ln/scale", device), get("embeddings_ln/bias", device),
                      c.layer_norm_eps)


def pool(config, get, hidden):
    """The pooler: tanh of a Dense on the first token, on ``hidden``'s device."""
    return torch.tanh(_linear(hidden[:, 0], get("pooler/kernel", hidden.device), get("pooler/bias", hidden.device)))


def tp_encoder(config, get_rest, get_layer, input_ids, attention_mask, token_type_ids, devices,
               dropout_seed=None, sp=False, output_hidden_states=False, remat=False):
    """``BertEncoder.forward`` over the model devices of one data shard:
    embeddings (token-split under ``sp``), the layers through ``tp_layer``
    (``get_layer(i, suffix, j)``) and the pooler on ``devices[0]``.
    ``get_rest(name, device)`` gives the encoder's own leaves. Returns
    (sequence, pooled[, every layer's output]) on ``devices[0]``, as
    ``BertEncoder.forward`` does."""
    from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

    c = config
    tp = len(devices)
    lead = devices[0]
    length = input_ids.shape[1]
    if sp and length % tp:
        raise ValueError(f"sequence length {length} does not divide over model={tp} (trainer.sp)")
    if sp:
        blk = length // tp
        hidden = [embed(c, get_rest, input_ids[:, k * blk:(k + 1) * blk], token_type_ids[:, k * blk:(k + 1) * blk],
                        devices[k], start=k * blk) for k in range(tp)]
        hidden = [_dropout(h, c.hidden_dropout_prob, dropout_seed, 0) for h in hidden]
    else:
        h0 = _dropout(embed(c, get_rest, input_ids, token_type_ids, lead), c.hidden_dropout_prob, dropout_seed, 0)
        hidden = [h0.to(d) for d in devices]
    mask = attention_mask.bool()

    def gathered(parts):
        return torch.cat([p.to(lead) for p in parts], dim=1) if sp else parts[0]

    all_hidden = [gathered(hidden)]
    for i in range(c.num_layers):
        seed = None if dropout_seed is None else dropout_generator_seed(dropout_seed, i + 1)

        def run(*parts, i=i, seed=seed):
            return tuple(tp_layer(c, lambda s, j: get_layer(i, s, j), list(parts), mask, devices, seed, sp))

        if remat and torch.is_grad_enabled():
            hidden = list(torch.utils.checkpoint.checkpoint(run, *hidden, use_reentrant=False))
        else:
            hidden = list(run(*hidden))
        if output_hidden_states:
            all_hidden.append(gathered(hidden))
    seq = gathered(hidden)
    pooled = pool(c, get_rest, seq)
    if output_hidden_states:
        return seq, pooled, all_hidden
    return seq, pooled
