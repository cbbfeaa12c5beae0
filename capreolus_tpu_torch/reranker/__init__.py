"""Reranker modules: neural second-stage models (the JAX package's
``reranker/__init__.py``).

A reranker builds an ``nn.Module`` (``build_model``) whose parameters are the
model's weights (the JAX package keeps them in a pytree the trainer owns),
scores a collated batch (``score`` for training, ``[pos, neg]``; ``test`` for
prediction), and says which parameter paths are trainable. Paths are the
flattened JAX parameter tree's (``("params", "combine", "kernel")``), so one
``trainable`` serves the trainer, the checkpoints and the JAX tests. Its
``trainer`` dependency (default ``jax``, the port's ``TorchTrainer``) trains
it; weights may also arrive as a flat ``params/...`` npz (``convert.py``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from capreolus_tpu_torch.core import Dependency, ModuleBase, import_all_modules, register_module_type


@register_module_type
class Reranker(ModuleBase):
    module_type = "reranker"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="embedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    # rerankers whose models apply dropout set this True; the trainer then hands
    # a training forward its dropout seed (the JAX package's "dropout" rng)
    accepts_rngs = False

    def build_model(self) -> torch.nn.Module:
        """Create and return the torch model (cached on self.model)."""
        raise NotImplementedError

    def build_train_model(self) -> torch.nn.Module:
        """The model the trainer trains (``build_model()``'s unless an
        inference-only variant differs)."""
        return self.build_model()

    def init_params(self, seed: int) -> torch.nn.Module:
        """Build the model and draw its weights as flax initialises the JAX
        model's, from a ``torch.Generator`` seeded with ``seed`` (the JAX
        ``init_params`` draws from ``PRNGKey(seed)``; the values differ, the
        distributions are the same)."""
        from capreolus_tpu_torch.convert import init_flax_

        return init_flax_(self.build_train_model(), torch.Generator().manual_seed(int(seed)))

    def state_dict_from_params(self, flat: dict) -> dict:
        """Map a flat ``params/...`` dict of the JAX parameter tree to the
        model's ``state_dict``."""
        raise NotImplementedError

    def trainable(self, path: tuple, value) -> bool:
        """Whether the parameter at ``path`` (tuple of name strings) is trainable.
        Frozen paths are left out of the optimizer and of checkpoints."""
        return True

    @staticmethod
    def put(batch, key, device):
        return torch.from_numpy(np.asarray(batch[key])).to(device)

    def score(self, batch, device, dropout_seed=None):
        """[pos_scores, neg_scores] for a training batch."""
        raise NotImplementedError

    def test(self, batch, device):
        """Scores [B] for the batch's posdoc, as a tensor on ``device``."""
        raise NotImplementedError

    # default score/test implementations for models with the
    # forward(querytoks, doctoks, query_idf) -> [B] signature
    def score_default(self, batch, device, dropout_seed=None):
        query, idf = self.put(batch, "query", device), self.put(batch, "query_idf", device)
        pos = self.model(query, self.put(batch, "posdoc", device), idf)
        neg = self.model(query, self.put(batch, "negdoc", device), idf)
        return [pos.reshape(-1), neg.reshape(-1)]

    def test_default(self, batch, device):
        return self.model(self.put(batch, "query", device), self.put(batch, "posdoc", device),
                          self.put(batch, "query_idf", device)).reshape(-1)

    def add_summary(self, niter, output_path):
        """Write per-parameter statistics for iteration ``niter`` to
        ``param_stats_{niter}.json``, named and shaped as the JAX parameter
        tree's leaves (frozen leaves included, as the JAX reranker writes them)."""
        from capreolus_tpu_torch.convert import flax_flat_params

        stats = {}
        for key, arr in flax_flat_params(self.build_train_model()).items():
            if arr.size == 0:
                continue
            stats[key] = {"shape": list(arr.shape), "mean": float(arr.mean()), "std": float(arr.std()),
                          "min": float(arr.min()), "max": float(arr.max())}
        output_path = Path(output_path)
        output_path.mkdir(parents=True, exist_ok=True)
        with open(output_path / f"param_stats_{niter}.json", "wt") as f:
            json.dump(stats, f, indent=1)


import_all_modules(__file__, __package__)
import capreolus_tpu_torch.trainer  # noqa: E402,F401  (registers the trainer the dependency names)
