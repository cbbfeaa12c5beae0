"""Trainable learned-sparse term weighting (uniCOIL-style): the JAX package's
``reranker/unicoil.py``.

A shared encoder gives every token a non-negative weight (ReLU of a linear
head, ``tokweight``, over its contextual embedding), and the score is the
exact-match dot product

    score(q, d) = sum over query positions i of  qw_i * max_{j : d_j == q_i} dw_j

(document term impact = max over occurrences, query weight = sum over
occurrences): what the impact searcher computes from an inverted index, so a
trained checkpoint serves as ``searcher.name=impact``'s ``checkpointfile``
in either package. [CLS], [SEP] and [PAD] carry context but never score.
"""

from __future__ import annotations

import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigOption
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder
from capreolus_tpu_torch.reranker.biencoder import BertRetrieverBase, _seed, encoder_inputs


class UniCoilModel(nn.Module):
    """Shared-encoder token weighting + exact-match interaction."""

    def __init__(self, config: BertConfig, cls_id: int = 101, sep_id: int = 102):
        super().__init__()
        self.config = config
        self.cls_id, self.sep_id = cls_id, sep_id
        self.bert = BertEncoder(config)
        self.tokweight = nn.Linear(config.hidden_size, 1)

    def weights(self, toks, dropout_seed=None):
        """(truncated ids [B, L], token weights [B, L]: ReLU of the head, 0 on pads)."""
        toks, mask = encoder_inputs(toks, self.config.max_position)
        hidden, _ = self.bert(toks, mask, torch.zeros_like(toks), dropout_seed=dropout_seed)
        w = torch.relu(self.tokweight(hidden.float())[..., 0])
        return toks, w * mask

    def forward(self, querytoks, doctoks, query_idf=None, dropout_seed=None):
        q, qw = self.weights(querytoks, _seed(dropout_seed, 0))
        d, dw = self.weights(doctoks, _seed(dropout_seed, 1))
        valid_q = (q != 0) & (q != self.cls_id) & (q != self.sep_id)
        valid_d = (d != 0) & (d != self.cls_id) & (d != self.sep_id)
        match = (q[:, :, None] == d[:, None, :]) & valid_q[:, :, None] & valid_d[:, None, :]
        dmax = torch.where(match, dw[:, None, :], 0.0).amax(dim=-1)  # [B, Lq]
        return (qw * dmax * valid_q.float()).sum(dim=-1)


@Reranker.register
class UniCoil(BertRetrieverBase):
    """Learned-sparse retriever trained in-framework; export via searcher.name=impact."""

    module_name = "unicoil"
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "encoder checkpoint (or 'tiny' offline)"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh or erf"),
        ConfigOption("allowrandominit", False, "allow random init when the checkpoint cannot be loaded"),
        ConfigOption("hidden_dropout_prob", 0.1, "encoder dropout during training"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            tok = self.extractor.tokenizer
            self.model = UniCoilModel(self.encoder_config(), cls_id=int(tok.cls_id), sep_id=int(tok.sep_id))
            self._load_pretrained(self.model)
        return self.model
