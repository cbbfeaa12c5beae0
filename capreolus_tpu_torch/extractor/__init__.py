"""Extractor modules: turn (qid, docid) pairs into model-ready feature arrays
(the JAX package's ``extractor/__init__.py``).

``preprocess(qids, docids, topics)`` builds vocabulary/embedding state (cached,
keyed by an md5 over the sorted qids+docids), then ``id2vec(qid, posid, negid,
label, training)`` returns a dict of numpy arrays for one sample.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path

from capreolus_tpu_torch.core import ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@register_module_type
class Extractor(ModuleBase):
    """Base class for Extractor modules."""

    module_type = "extractor"
    pad_tok = "<pad>"

    def get_state_cache_file_path(self, qids, docids):
        """Cache file path keyed by an md5 over the sorted qids and docids."""
        digest = hashlib.md5(str(sorted(qids) + sorted(docids)).encode("utf-8")).hexdigest()
        return self.get_cache_path() / "state" / f"{digest}.pkl"

    def _cache_state(self, qids, docids):
        self.save_state(self.get_state_cache_file_path(qids, docids))

    def _load_state_from_cache(self, qids, docids) -> bool:
        # the state cache holds only pickles this package wrote under its cache path
        path = self.get_state_cache_file_path(qids, docids)
        if not path.exists():
            return False
        try:
            self.load_state(path)
            return True
        except (OSError, pickle.UnpicklingError, EOFError) as e:
            logger.warning("failed loading extractor state cache %s: %s", path, e)
            return False

    def save_state(self, path):
        """Serialize the preprocessed state to an explicit file."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.get_state(), f, protocol=-1)

    def load_state(self, path):
        """Restore state written by ``save_state`` (marks preprocessed)."""
        with open(path, "rb") as f:
            self.set_state(pickle.load(f))

    def get_state(self):
        raise NotImplementedError

    def set_state(self, state):
        raise NotImplementedError

    def preprocess(self, qids, docids, topics):
        raise NotImplementedError

    def id2vec(self, qid, posid, negid=None, label=None, training=True):
        raise NotImplementedError


import_all_modules(__file__, __package__)
