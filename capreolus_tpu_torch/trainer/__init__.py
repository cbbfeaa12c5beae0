"""Trainer modules (the JAX package's ``trainer/__init__.py``): loss history
persistence with the two-writer consistency check, metric json helpers,
``n_batch_per_iter``, early-stopping paths, and the warmup +
exponential/linear decay learning-rate multiplier. One trainer
(``trainer/torch_trainer.py``, registered as ``jax``, ``pytorch`` and
``tensorflow``) trains every reranker; ``collate.py`` stacks samples into
batches.
"""

from __future__ import annotations

import json
import os

import numpy as np

from capreolus_tpu_torch.core import ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@register_module_type
class Trainer(ModuleBase):
    module_type = "trainer"
    requires_random_seed = True

    @staticmethod
    def load_loss_file(fn):
        """Load loss history; raises IOError on index gaps (two-writer detection,
        parity: trainer/__init__.py:22-48)."""
        loss = []
        with open(fn, "rt") as f:
            lineidx = 0
            for line in f:
                line = line.strip()
                if not line:
                    continue
                iteridx, iterloss = line.split()
                if int(iteridx) != lineidx:
                    raise IOError(f"malformed loss file {fn} ... did two processes write to it?")
                loss.append(float(iterloss))
                lineidx += 1
        return loss

    @staticmethod
    def write_to_loss_file(fn, losses):
        fn.write_text("\n".join(f"{idx} {loss}" for idx, loss in enumerate(losses)))

    @staticmethod
    def load_metric(fn):
        with open(fn, "rt") as f:
            return json.load(f)

    @staticmethod
    def load_best_metric(fn, metric):
        return Trainer.load_metric(fn).get(metric, -np.inf)

    @staticmethod
    def write_to_metric_file(fn, metrics):
        assert isinstance(metrics, dict)
        with open(fn, "wt") as f:
            json.dump(metrics, f)

    @staticmethod
    def exhaust_used_train_data(train_data_generator, n_batch_to_exhaust):
        for i, _ in enumerate(train_data_generator):
            if (i + 1) == n_batch_to_exhaust:
                break

    @property
    def n_batch_per_iter(self):
        return (self.config["itersize"] // self.config["batch"]) or 1

    @staticmethod
    def get_paths_for_early_stopping(train_output_path, dev_output_path):
        dev_best_weight_fn = train_output_path / "dev.best"
        weights_output_path = train_output_path / "weights"
        info_output_path = train_output_path / "info"
        os.makedirs(dev_output_path, exist_ok=True)
        os.makedirs(weights_output_path, exist_ok=True)
        os.makedirs(info_output_path, exist_ok=True)
        return dev_best_weight_fn, weights_output_path, info_output_path, info_output_path / "loss.txt", dev_output_path / "metrics.json"

    def lr_multiplier(self, step):
        """Warmup then exponential/linear decay (parity: trainer/__init__.py:98-109)."""
        warmup_steps = self.config["warmupiters"] * self.n_batch_per_iter
        if warmup_steps and step <= warmup_steps:
            return min((step + 1) / warmup_steps, 1.0)
        if self.config["decaytype"] == "exponential":
            decay_steps = self.config["decayiters"] * self.n_batch_per_iter
            return self.config["decay"] ** ((step - warmup_steps) / decay_steps)
        if self.config["decaytype"] == "linear":
            epoch = (step - warmup_steps) / self.n_batch_per_iter
            return 1.0 / (1.0 + self.config["decay"] * epoch)
        return 1.0

    def change_lr(self, step, lr):
        return lr * self.lr_multiplier(step)


import_all_modules(__file__, __package__)
