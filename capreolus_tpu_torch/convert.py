"""Weights carried across from and to the JAX package.

The JAX parameter tree, flattened to ``"params/<module>/<leaf>"`` paths of
numpy arrays, is the port's exchange format: ``save_params`` writes it as an
``.npz`` and ``load_params`` reads it back, or a ``.params`` file in flax's
own msgpack bytes (a ``dev.best`` of either trainer). ``knrm_state_dict``
maps it onto ``KNRMModel``'s ``state_dict`` and ``bert_state_dict`` onto
``_BertScorer``'s (int8 stats included) or ``ColBERTModel``'s.
``flax_flat_params`` is the inverse for any port model whose modules carry the
flax modules' names: every parameter, in the JAX tree's order, as the JAX
parameter of the same path (an ``nn.Linear`` ``weight`` [out, in] as a Dense
``kernel`` [in, out], a LayerNorm ``weight`` as its ``scale``).
``init_flax_`` draws those parameters as flax initialises them.
"""

from __future__ import annotations

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


def load_params(path) -> dict:
    """A flat ``{"params/...": array}`` dict from an .npz, a flax ``.params``
    file, or a checkpoint's stem (``dev.best``, whose ``dev.best.params``
    either trainer writes)."""
    path = Path(path)
    if not path.exists() and path.with_name(path.name + ".params").exists():
        path = path.with_name(path.name + ".params")
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


def _flax_leaves(model: torch.nn.Module):
    """(JAX key, torch parameter name, transposed) for every parameter of
    ``model``, in module order: a module's own parameters, then its children's,
    which is the order flax creates a compact module's parameters in."""
    leaves = []
    for mname, module in model.named_modules():
        parts = mname.split(".") if mname else []
        for pname, _ in module.named_parameters(recurse=False):
            leaf, transposed = pname, False
            if isinstance(module, torch.nn.Linear):
                leaf, transposed = {"weight": ("kernel", True), "bias": ("bias", False)}[pname]
            elif isinstance(module, torch.nn.LayerNorm):
                leaf = {"weight": "scale", "bias": "bias"}[pname]
            torch_name = f"{mname}.{pname}" if mname else pname
            leaves.append(("/".join(["params"] + parts + [leaf]), torch_name, transposed))
    return leaves


def flax_flat_params(model: torch.nn.Module) -> dict:
    """The model's parameters as the flat JAX parameter dict (f32 numpy, in the
    JAX tree's order)."""
    params = dict(model.named_parameters())
    out = {}
    for key, name, transposed in _flax_leaves(model):
        value = params[name].detach().to("cpu", torch.float32)
        out[key] = np.array((value.T if transposed else value).numpy(), order="C")  # a copy, never a view
    return out


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: a normal truncated at two standard deviations,
    its scale divided by the truncated normal's own std (0.8796...) so that the
    variance is 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        return torch.nn.init.trunc_normal_(weight, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                                           generator=generator)


def init_flax_(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw ``model``'s weights as flax initialises their counterparts: every
    ``nn.Linear`` (a flax ``nn.Dense``) ``lecun_normal`` with a zero bias, every
    ``nn.LayerNorm`` unit scale and zero bias, and a module's other parameters
    by its own ``flax_init_(generator)`` where it has one (BERT's embedding
    tables); other parameters keep their values. The draws come from
    ``generator`` in module order."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, torch.nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif hasattr(module, "flax_init_"):
                module.flax_init_(generator)
    return model



def _present(flat, key):
    value = flat.get(key)
    return value is not None and np.asarray(value).size > 0


def _dense(flat, prefix, name):
    """flax Dense kernel [in, out] -> nn.Linear weight [out, in]."""
    kernel = np.asarray(flat[f"{prefix}/{name}/kernel"], dtype=np.float32)
    bias = np.array(flat[f"{prefix}/{name}/bias"], dtype=np.float32)
    return {f"{name}.weight": torch.from_numpy(np.array(kernel.T, order="C")),
            f"{name}.bias": torch.from_numpy(bias)}


def knrm_state_dict(flat: dict, embedding: np.ndarray = None) -> dict:
    """KNRMModel state_dict from the flat JAX KNRM params.

    A JAX checkpoint leaves out frozen leaves (empty arrays or absent): the
    embedding table is then refilled from ``embedding`` (the extractor's
    table) and the kernel bank from the KNRM defaults, never kept stale.
    """
    prefix = "params"
    state = {}
    if _present(flat, f"{prefix}/embedding"):
        state["embedding"] = torch.from_numpy(np.array(flat[f"{prefix}/embedding"], dtype=np.float32))
    elif embedding is not None:
        state["embedding"] = torch.from_numpy(np.array(embedding, dtype=np.float32))
    else:
        raise KeyError("the checkpoint has no embedding table and no extractor table was given")
    for name, default in (("mus", KNRM_MUS), ("sigmas", KNRM_SIGMAS)):
        value = flat[f"{prefix}/{name}"] if _present(flat, f"{prefix}/{name}") else default
        state[name] = torch.from_numpy(np.array(value, dtype=np.float32))
    if f"{prefix}/combine/kernel" in flat:
        state.update(_dense(flat, prefix, "combine"))
    else:
        state.update(_dense(flat, prefix, "combine1"))
        state.update(_dense(flat, prefix, "combine2"))
    return state


def bert_state_dict(flat: dict) -> dict:
    """The state_dict of a BERT-based model from its flat JAX variables: a
    ``_BertScorer``'s (``params/bert/layer_0/attention/query/kernel``, ...,
    ``params/classifier/bias``) or a ``ColBERTModel``'s (``params/bert/...``,
    ``params/linear/kernel``). The port's modules carry the flax modules'
    names, so each path maps by name: a Dense ``kernel`` [in, out] becomes an
    ``nn.Linear`` ``weight`` [out, in], a LayerNorm ``scale`` its ``weight``.
    The int8 model's ``quant_stats`` collection maps onto its buffers the same
    way: ``quant_stats/bert/layer_i/gelu_amax`` -> ``bert.layer_i.gelu_amax``."""
    state = {}
    for key, value in flat.items():
        root, *path, leaf = key.split("/")
        if root not in ("params", "quant_stats") or not path:
            raise KeyError(f"not a flattened _BertScorer variable: {key!r}")
        value = np.asarray(value, dtype=np.float32)
        if root == "params" and leaf == "kernel":
            leaf, value = "weight", value.T
        elif root == "params" and leaf == "scale":
            leaf = "weight"
        state[".".join(path + [leaf])] = torch.from_numpy(np.array(value, order="C"))
    return state
