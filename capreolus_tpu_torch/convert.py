"""Weights carried across from and to the JAX package.

The JAX parameter tree, flattened to ``"params/<module>/<leaf>"`` paths of
numpy arrays, is the port's exchange format: ``save_params`` writes it as an
``.npz`` and ``load_params`` reads it back, or a ``.params`` file in flax's
own msgpack bytes (a ``dev.best`` of either trainer). ``knrm_state_dict``
maps it onto ``KNRMModel``'s ``state_dict`` (``flax_state_dict`` with the
frozen leaves refilled) and ``bert_state_dict`` onto
any BERT reranker's model (``_BertScorer``, PARADE, CEDR-KNRM, Birch, MoE
layers and int8 stats included) or ``ColBERTModel``'s.
``flax_flat_params`` is the inverse for any port model whose modules carry the
flax modules' names: every parameter, in the JAX tree's order, as the JAX
parameter of the same path, through its layer's layout (``flax_leaves``):
- an ``nn.Linear`` ``weight`` [out, in] is a Dense ``kernel`` [in, out];
  a ``DenseGeneral`` (a Linear with ``flax_in_shape`` / ``flax_out_shape``)
  is flax's ``DenseGeneral`` kernel [*in_shape, *out_shape] and bias
  [*out_shape] (``MultiHeadDotProductAttention``'s query, key and value
  [E, H, D], its out [H, D, E]);
- an ``nn.Conv1d`` / ``nn.Conv2d`` ``weight`` [out, in, *k] is a flax
  ``Conv`` kernel [*k, in, out];
- a ``nn.LayerNorm`` ``weight`` is its ``scale``;
- any other parameter (an embedding table, a kernel bank, HINT's raw
  ``Wrz_kernel``) keeps its name and layout.
flax's ``GRUCell`` and ``OptimizedLSTMCell`` are modules of such Dense
layers (``ir``, ``hn``, ``ii``, ``hf``, ...), so they carry over by name.
``flax_state_dict`` maps a flat dict back onto any such model, checking every
shape. ``init_flax_`` draws those parameters as flax initialises them.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from capreolus_tpu_torch.reranker.common import KNRM_MUS, KNRM_SIGMAS


def save_params(flat: dict, path) -> Path:
    """Write a flat ``{"params/...": array}`` dict as an .npz (the port's checkpoint)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
    return path


def params_file(path) -> Path:
    """The file a checkpoint path names: ``path`` itself, or for a stem
    (``dev.best``) that does not exist, the ``.params`` file beside it (or
    the ``.params.shards`` directory of ``trainer.ckpt=sharded``)."""
    path = Path(path)
    if not path.exists():
        for suffix in (".params", ".params.shards"):
            if path.with_name(path.name + suffix).exists():
                return path.with_name(path.name + suffix)
    return path


def load_params(path) -> dict:
    """A flat ``{"params/...": array}`` dict from an .npz, a flax ``.params``
    file, a checkpoint's stem (``dev.best``, whose ``dev.best.params`` either
    trainer writes), or a ``trainer.ckpt=sharded`` directory
    (``utils/sharded_ckpt.py``; a tree without the ``params`` level gets it,
    as the JAX searchers' ``restored.get("params", restored)`` reads it)."""
    path = params_file(path)
    if path.is_dir():
        from capreolus_tpu_torch.utils.sharded_ckpt import restore_params

        tree = restore_params(path)
        return flatten_tree(tree if "params" in tree else {"params": tree})
    if path.name.endswith(".params"):
        from capreolus_tpu_torch.utils.flax_msgpack import from_bytes

        return flatten_tree(from_bytes(path.read_bytes()))
    with np.load(path, allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


def flatten_tree(tree, prefix="") -> dict:
    """Nested dicts -> ``{"a/b/c": leaf}`` in the tree's order."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten_tree(value, name))
        else:
            out[name] = value
    return out


def unflatten_tree(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` -> nested dicts, keys in the flat dict's order."""
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _is_dense_general(module) -> bool:
    return isinstance(module, torch.nn.Linear) and getattr(module, "flax_in_shape", None) is not None


def _layout(module, pname, param):
    """(flax leaf name, torch -> flax function, flax -> torch function, flax
    shape) of ``module``'s parameter ``pname``."""
    if _is_dense_general(module):
        ins, outs = tuple(module.flax_in_shape), tuple(module.flax_out_shape)
        if pname == "weight":
            return ("kernel", lambda t: t.T.reshape(ins + outs),
                    lambda a: a.reshape(int(np.prod(ins)), int(np.prod(outs))).T, ins + outs)
        return ("bias", lambda t: t.reshape(outs), lambda a: a.reshape(-1), outs)
    if isinstance(module, torch.nn.Linear) and pname == "weight":
        return "kernel", lambda t: t.T, lambda a: a.T, tuple(param.shape[::-1])
    if isinstance(module, (torch.nn.Conv1d, torch.nn.Conv2d)) and pname == "weight":
        nd = param.dim() - 2  # [out, in, *k] <-> [*k, in, out]
        to_flax = tuple(range(2, 2 + nd)) + (1, 0)
        from_flax = (nd + 1, nd) + tuple(range(nd))
        return ("kernel", lambda t: t.permute(to_flax), lambda a: a.permute(from_flax),
                tuple(param.shape[i] for i in to_flax))
    if isinstance(module, torch.nn.LayerNorm) and pname == "weight":
        return "scale", lambda t: t, lambda a: a, tuple(param.shape)
    return pname, lambda t: t, lambda a: a, tuple(param.shape)


def flax_leaves(model: torch.nn.Module):
    """(JAX key, torch parameter name, torch -> flax, flax -> torch, flax
    shape) for every parameter of ``model``, in module order: a module's own
    parameters, then its children's, which is the order flax creates a
    compact module's parameters in."""
    out = []
    for mname, module in model.named_modules():
        parts = mname.split(".") if mname else []
        for pname, param in module.named_parameters(recurse=False):
            leaf, to_flax, from_flax, shape = _layout(module, pname, param)
            out.append(("/".join(["params"] + parts + [leaf]), f"{mname}.{pname}" if mname else pname,
                        to_flax, from_flax, shape))
    return out


def flax_flat_params(model: torch.nn.Module) -> dict:
    """The model's parameters as the flat JAX parameter dict (f32 numpy, in the
    JAX tree's order)."""
    params = dict(model.named_parameters())
    out = {}
    for key, name, to_flax, _, _ in flax_leaves(model):
        value = to_flax(params[name].detach().to("cpu", torch.float32))
        out[key] = np.array(value.numpy(), order="C")  # a copy, never a view
    return out


def flax_state_dict(model: torch.nn.Module, flat: dict, refill: dict = None) -> dict:
    """``model``'s parameters from the flat JAX parameter dict, each through
    its layer's layout and checked against the shape the model gives it.
    A leaf the checkpoint leaves out or empty (a frozen leaf) takes its value
    from ``refill`` (by JAX key), else keeps the model's own, as the JAX
    trainer's ``_merge_frozen`` does. A key the model lacks raises."""
    params = dict(model.named_parameters())
    leaves = flax_leaves(model)
    unknown = sorted(set(flat) - {key for key, *_ in leaves})
    if unknown:
        raise KeyError(f"{type(model).__name__} has no parameter for {unknown[:3]}")
    state = {}
    for key, name, _, from_flax, shape in leaves:
        if _present(flat, key):
            value = np.asarray(flat[key], dtype=np.float32)
            if tuple(value.shape) != shape:
                raise ValueError(f"{key}: the checkpoint's shape {tuple(value.shape)} is not the model's {shape}")
            state[name] = from_flax(torch.from_numpy(np.array(value, order="C"))).contiguous()
        elif refill is not None and key in refill:
            state[name] = torch.as_tensor(np.asarray(refill[key], dtype=np.float32)).reshape(params[name].shape)
        else:
            state[name] = params[name].detach().to("cpu", torch.float32).clone()
    return state


def orthogonal_(weight: torch.Tensor, generator: torch.Generator):
    """flax's ``orthogonal()`` of a recurrent kernel [H, H] (a Haar draw: the Q
    of a normal matrix's QR, its columns' signs fixed by R's diagonal)."""
    with torch.no_grad():
        return torch.nn.init.orthogonal_(weight, gain=1.0, generator=generator)


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    its scale divided by the truncated normal's own std (0.8796...) so that the
    variance is 1 / fan_in. Drawn by the inverse CDF, as
    ``jax.random.truncated_normal`` draws it (a uniform between the bounds'
    CDF values, then ``erfinv``), in the steps of torch 2.11's
    ``torch.nn.init.trunc_normal_``: torch 2.13's samples by rejection, so
    its values at a seed differ from 2.11's."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978

    def norm_cdf(x):
        return (1.0 + math.erf(x / math.sqrt(2.0))) / 2.0

    lo, hi = norm_cdf(-2.0), norm_cdf(2.0)
    with torch.no_grad():
        weight.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        weight.erfinv_()
        weight.mul_(std * math.sqrt(2.0))
        return weight.clamp_(min=-2.0 * std, max=2.0 * std)


def init_flax_(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw ``model``'s weights as flax initialises their counterparts: a
    module's own parameters by its ``flax_init_(generator)`` where it has one
    (BERT's embedding tables, a LoRA adapter's Dense layers, a recurrent
    cell's hidden-state Dense layers, HINT's spatial GRU), every other
    ``nn.Linear`` (a flax ``nn.Dense`` or ``DenseGeneral``) ``lecun_normal``
    over its input features with a zero bias, every ``nn.Conv1d`` /
    ``nn.Conv2d`` (a flax ``nn.Conv``) ``lecun_normal`` over its receptive
    field times its input channels with a zero bias, every ``nn.LayerNorm``
    unit scale and zero bias; other parameters keep their values. The draws
    come from ``generator`` in module order."""
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, "flax_init_"):
                module.flax_init_(generator)
            elif isinstance(module, torch.nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (torch.nn.Conv1d, torch.nn.Conv2d)):
                lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, torch.nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    return model


def _present(flat, key):
    value = flat.get(key)
    return value is not None and np.asarray(value).size > 0


def knrm_state_dict(flat: dict, embedding: np.ndarray = None, model: torch.nn.Module = None) -> dict:
    """KNRMModel state_dict from the flat JAX KNRM params, through
    ``flax_state_dict`` (``model``, else a KNRMModel of the checkpoint's
    shapes).

    A JAX checkpoint leaves out frozen leaves (empty arrays or absent): the
    embedding table is then refilled from ``embedding`` (the extractor's
    table) and the kernel bank from the KNRM defaults, never kept stale.
    """
    table = flat["params/embedding"] if _present(flat, "params/embedding") else embedding
    if table is None:
        raise KeyError("the checkpoint has no embedding table and no extractor table was given")
    if model is None:
        from capreolus_tpu_torch.reranker.knrm import KNRMModel

        model = KNRMModel(np.zeros(np.shape(table), np.float32), singlefc="params/combine/kernel" in flat)
    return flax_state_dict(model, flat, {"params/embedding": table, "params/mus": KNRM_MUS,
                                         "params/sigmas": KNRM_SIGMAS})


def bert_state_dict(flat: dict) -> dict:
    """The state_dict of a BERT-based model from its flat JAX variables: a
    ``_BertScorer``'s (``params/bert/layer_0/attention/query/kernel``, ...,
    ``params/classifier/bias``), a ``ColBERTModel``'s (``params/bert/...``,
    ``params/linear/kernel``), PARADE's (``params/agg_layer_0/...``,
    ``params/passage_position_embeddings``, ``params/agg_cls``), CEDR-KNRM's
    (``params/mus``, ``params/sigmas``, ``params/combine_hidden/kernel``, ...)
    or Birch's (``params/relevance/kernel``, ``params/topk_weights``, ...),
    MoE layers included (``params/bert/layer_i/moe/gate/kernel``,
    ``.../moe/experts_wi``). The port's modules carry the flax modules' names,
    so each path maps by name: a Dense ``kernel`` [in, out] becomes an
    ``nn.Linear`` ``weight`` [out, in], a LayerNorm ``scale`` its ``weight``,
    and any other leaf keeps its name and layout. The int8 model's
    ``quant_stats`` collection maps onto its buffers the same way:
    ``quant_stats/bert/layer_i/gelu_amax`` -> ``bert.layer_i.gelu_amax``."""
    state = {}
    for key, value in flat.items():
        root, *path, leaf = key.split("/")
        if root not in ("params", "quant_stats") or (root == "quant_stats" and not path):
            raise KeyError(f"not a flattened BERT-model variable: {key!r}")
        value = np.asarray(value, dtype=np.float32)
        if root == "params" and leaf == "kernel":
            leaf, value = "weight", value.T
        elif root == "params" and leaf == "scale":
            leaf = "weight"
        state[".".join(path + [leaf])] = torch.from_numpy(np.array(value, order="C"))
    return state
