"""KNRM: kernel-pooled neural ranking (the JAX package's ``reranker/knrm.py``;
Xiong et al., End-to-End Neural Ad-hoc Ranking with Kernel Pooling, SIGIR'17):
RBF kernel bank over the query x doc similarity matrix, log-sum pooling, linear
combination, with the gradkernels / singlefc / scoretanh / finetune options.
``add_summary`` writes the parameter statistics and, as the JAX reranker
does, the combine weights as a figure (``combine_weight_{niter}.png``) when
matplotlib imports.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigOption
from capreolus_tpu_torch.ops.simmat import knrm_simmat_pool
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.common import KNRM_MUS, KNRM_SIGMAS, knrm_pool, similarity_matrix
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


class KNRMModel(nn.Module):
    """Parameters: ``embedding`` [V, E], ``mus`` / ``sigmas`` [K], and the
    combine layer(s), named as the JAX model's (``combine`` or ``combine1`` +
    ``combine2``)."""

    amp_bf16_params = ("embedding",)  # gathered and normalised in bf16 under trainer.amp, as in JAX

    def __init__(self, embedding: np.ndarray, gradkernels=True, singlefc=True, scoretanh=False, finetune=False):
        super().__init__()
        self.gradkernels, self.singlefc, self.scoretanh, self.finetune = gradkernels, singlefc, scoretanh, finetune
        self.embedding = nn.Parameter(torch.as_tensor(np.asarray(embedding, dtype=np.float32)),
                                      requires_grad=finetune)
        self.mus = nn.Parameter(torch.tensor(KNRM_MUS, dtype=torch.float32), requires_grad=gradkernels)
        self.sigmas = nn.Parameter(torch.tensor(KNRM_SIGMAS, dtype=torch.float32), requires_grad=gradkernels)
        num_kernels = len(KNRM_MUS)
        if singlefc:
            self.combine = nn.Linear(num_kernels, 1)
        else:
            self.combine1 = nn.Linear(num_kernels, 30)
            self.combine2 = nn.Linear(30, 1)

    def forward(self, querytoks, doctoks, query_idf=None):
        if querytoks.is_cuda and not self.gradkernels and not self.finetune:
            # K1: fused simmat + kernel pooling, no [B, K, Q, D] in memory, in
            # training forwards and predictions alike. The kernel has no
            # backward: with kernels and embeddings frozen (no requires_grad)
            # no gradient flows through it, and only the combine layers train
            # (the JAX model takes its Pallas kernel under the same condition,
            # on stop_gradient inputs)
            pooled = knrm_simmat_pool(self.embedding, querytoks, doctoks, self.mus, self.sigmas)
        else:
            simmat = similarity_matrix(self.embedding, querytoks, doctoks)  # [B, Q, D]
            pooled = knrm_pool(simmat, self.mus, self.sigmas)  # [B, K]

        if self.singlefc:
            scores = self.combine(pooled)
        else:
            scores = self.combine2(torch.tanh(self.combine1(pooled)))
        if self.scoretanh:
            scores = torch.tanh(scores)
        return scores[:, 0]


@Reranker.register
class KNRM(Reranker):
    """Chenyan Xiong, Zhuyun Dai, Jamie Callan, Zhiyuan Liu, and Russell Power. 2017.
    End-to-End Neural Ad-hoc Ranking with Kernel Pooling. SIGIR'17."""

    module_name = "KNRM"
    config_spec = [
        ConfigOption("gradkernels", True, "backprop through mus and sigmas"),
        ConfigOption("scoretanh", False, "use a tanh on the prediction (as in paper)"),
        ConfigOption("singlefc", True, "single fully connected layer (as in paper)"),
        ConfigOption("finetune", False, "fine-tune the embedding layer"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = KNRMModel(
                embedding=self.extractor.embeddings,
                gradkernels=self.config["gradkernels"],
                singlefc=self.config["singlefc"],
                scoretanh=self.config["scoretanh"],
                finetune=self.config["finetune"],
            )
        return self.model

    def trainable(self, path, value):
        name = "/".join(str(p) for p in path)
        if "embedding" in name and not self.config["finetune"]:
            return False
        if ("mus" in name or "sigmas" in name) and not self.config["gradkernels"]:
            return False
        return True

    score = Reranker.score_default
    test = Reranker.test_default

    def add_summary(self, niter, output_path):
        """The parameter statistics, and with ``singlefc`` the combine layer's
        weights as ``combine_weight_{niter}.png`` (a matshow of its [1, K]
        kernel transposed; best-effort: nothing without matplotlib)."""
        super().add_summary(niter, output_path)
        if not self.config["singlefc"]:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            weight = self.build_train_model().combine.weight.detach().cpu().numpy()  # the flax kernel [K, 1], transposed
            fig = plt.figure()
            ax = fig.add_subplot(1, 1, 1)
            ax.matshow(weight)
            fig.savefig(Path(output_path) / f"combine_weight_{niter}.png", bbox_inches="tight")
            plt.close(fig)
        except Exception as e:  # plotting must never break training
            logger.debug("combine-weight figure not written: %s", e)

    def state_dict_from_params(self, flat, model=None):
        from capreolus_tpu_torch.convert import knrm_state_dict

        return knrm_state_dict(flat, self.extractor.embeddings, model if model is not None else self.build_model())
