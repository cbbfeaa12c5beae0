"""Reranker modules: neural second-stage models (the JAX package's
``reranker/__init__.py``).

A reranker builds an ``nn.Module`` (``build_model``), scores a collated batch
(``test``), and says which parameter paths are trainable. Until the trainer is
ported, a reranker declares no ``trainer`` dependency; its weights arrive as a
flat ``params/...`` npz (``convert.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from capreolus_tpu_torch.core import Dependency, ModuleBase, import_all_modules, register_module_type


@register_module_type
class Reranker(ModuleBase):
    module_type = "reranker"
    dependencies = [Dependency(key="extractor", module="extractor", name="embedtext")]

    def build_model(self) -> torch.nn.Module:
        """Create and return the torch model (cached on self.model)."""
        raise NotImplementedError

    def state_dict_from_params(self, flat: dict) -> dict:
        """Map a flat ``params/...`` dict of the JAX parameter tree to the
        model's ``state_dict``."""
        raise NotImplementedError

    def trainable(self, path: tuple, value) -> bool:
        """Whether the parameter at ``path`` (tuple of name strings) is trainable.
        Frozen paths are left out of checkpoints."""
        return True

    def test(self, batch, device):
        """Scores [B] for the batch's posdoc, as a tensor on ``device``."""
        raise NotImplementedError

    def test_default(self, batch, device):
        """``test`` for models with the ``forward(querytoks, doctoks, query_idf)`` signature."""

        def put(key):
            return torch.from_numpy(np.asarray(batch[key])).to(device)

        return self.model(put("query"), put("posdoc"), put("query_idf")).reshape(-1)


import_all_modules(__file__, __package__)
