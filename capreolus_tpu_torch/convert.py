"""Weights carried across from the JAX package.

The JAX parameter tree, flattened to ``"params/<module>/<leaf>"`` paths of
numpy arrays, is the port's checkpoint for now: ``save_params`` writes it as an
``.npz`` and ``load_params`` reads it back. ``knrm_state_dict`` maps it onto
``KNRMModel``'s ``state_dict`` and ``bert_state_dict`` onto ``_BertScorer``'s
(int8 stats included) or ``ColBERTModel``'s.
Reading flax msgpack checkpoints comes with the trainer.
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
    with np.load(path, allow_pickle=False) as npz:
        return {k: npz[k] for k in npz.files}


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
