"""BERT cross-encoder rerankers (the JAX package's ``reranker/bert_rerankers.py``):
monoBERT-MaxP (``BERTMaxP``, Dai & Callan 2019) and the aliases of the
reference's configs (``ptBERTMaxP``, ``TFBERTMaxP``, ``TFVanillaBERT``).

Inference only: each passage of the ``bertpassage`` features goes through the
encoder and a linear relevance head, and a document's score aggregates its
passages' scores (max, first, sum or avg). PARADE, CEDR-KNRM and Birch, and
the trainer-facing parts (``score``, ``score_lce``, pipeline views, int8
calibration), come with later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder, load_pretrained_encoder

_QUANTIZE_OPT = ConfigOption("quantize", "none", "inference-time quantization: none (int8 is not ported yet)")
_DROPOUT_OPT = ConfigOption("hidden_dropout_prob", 0.1, "dropout probability of the encoder's hidden layers "
                            "during training (no effect at inference)")
_LORA_OPT = ConfigOption("lora", 0, "LoRA rank: 0 = full model (LoRA adapters are not ported yet)",
                         value_type="int")
_LORA_ALPHA_OPT = ConfigOption("loraalpha", 16.0, "LoRA scaling alpha (delta = alpha/r * BA x)")

# options whose non-default values select code this slice does not port
_UNPORTED = (
    ("quantize", lambda v: v not in (None, "none"), "int8 inference; ROADMAP.md, 'int8 with X1/X2'"),
    ("moeexperts", lambda v: v > 0, "the mixture-of-experts FFN; ROADMAP.md, 'the other BERT rerankers'"),
    ("lora", lambda v: v > 0, "LoRA adapters; ROADMAP.md, 'the trainer'"),
    ("remat", bool, "rematerialization in the backward pass; ROADMAP.md, 'the trainer'"),
)


def _flatten_passages(inp, mask, seg):
    """[B, P, L] -> ([B*P, L], B, P); [B, L] passes through with P=1."""
    if inp.dim() == 2:
        return inp, mask, seg, inp.shape[0], 1
    b, p, l = inp.shape
    return inp.reshape(b * p, l), mask.reshape(b * p, l), seg.reshape(b * p, l), b, p


def aggregate_passage_scores(scores, passage_mask, mode):
    """Aggregate [B, P] passage scores into [B] document scores."""
    if scores.shape[1] == 1:
        return scores[:, 0]
    if mode == "max":
        return torch.where(passage_mask, scores, -1e30).max(dim=1).values
    if mode == "first":
        return scores[:, 0]
    if mode == "sum":
        return torch.where(passage_mask, scores, 0.0).sum(dim=1)
    if mode == "avg":
        denom = torch.clamp_min(passage_mask.sum(dim=1), 1)
        return torch.where(passage_mask, scores, 0.0).sum(dim=1) / denom
    raise ValueError(f"unknown aggregation {mode!r}")


class _BertScorer(nn.Module):
    """Shared BERT + linear relevance head, scoring each passage."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        self.bert = BertEncoder(config)
        self.classifier = nn.Linear(config.hidden_size, 1)

    def forward(self, inp, mask, seg):
        flat_inp, flat_mask, flat_seg, b, p = _flatten_passages(inp, mask, seg)
        _, pooled = self.bert(flat_inp, flat_mask, flat_seg)
        return self.classifier(pooled.float())[:, 0].reshape(b, p)


class BertRerankerBase(Reranker):
    """Common scoring plumbing for cross-encoders over bertpassage features."""

    dependencies = [Dependency(key="extractor", module="extractor", name="bertpassage")]

    def build(self):
        for key, selects, what in _UNPORTED:
            if key in self.config and selects(self.config[key]):
                raise ConfigError(f"{self.module_name}: {key}={self.config[key]!r} selects {what} "
                                  f"(not ported to PyTorch yet)")
        gelu = self.config.get("gelu", "tanh")
        if gelu not in ("tanh", "erf"):
            raise ValueError(f"gelu must be 'tanh' or 'erf', got {gelu!r}")

    def encoder_config(self) -> BertConfig:
        cfg, _ = load_pretrained_encoder(self.config["pretrained"],
                                         allow_random_init=bool(self.config.get("allowrandominit", False)))
        return dataclasses.replace(cfg, gelu_approximate=self.config.get("gelu", "tanh") == "tanh")

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = _BertScorer(self.encoder_config())
        return self.model

    def state_dict_from_params(self, flat):
        from capreolus_tpu_torch.convert import bert_state_dict

        return bert_state_dict(flat)

    def _passage_mask(self, mask):
        """A passage counts when any of its positions is unmasked. Every
        passage holds an unmasked ``[CLS] query [SEP] ... [SEP]``, so a pad
        passage counts too, as in the JAX reranker (ROADMAP "Faults and
        differences")."""
        if mask.dim() == 2:
            return torch.ones((mask.shape[0], 1), dtype=torch.bool, device=mask.device)
        return mask.sum(dim=2) > 0

    def _head_scores(self, raw_scores, mask):
        """The model's [B, P] passage scores as [B] document scores."""
        return aggregate_passage_scores(raw_scores, self._passage_mask(mask), self.config.get("aggregation", "max"))

    def _score_doc(self, inp, mask, seg):
        return self._head_scores(self.model(inp, mask, seg), mask)

    def test(self, batch, device):
        def put(key):
            return torch.from_numpy(np.asarray(batch[key])).to(device)

        return self._score_doc(put("pos_bert_input"), put("pos_mask"), put("pos_seg"))


@Reranker.register
class BERTMaxP(BertRerankerBase):
    """monoBERT with passage-score aggregation (BERT-MaxP, Dai & Callan 2019).

    Registered as BERTMaxP; ptBERTMaxP and TFBERTMaxP resolve here too, for the
    reference's configs."""

    module_name = "BERTMaxP"
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "pretrained model: bert-base-uncased, "
                     "Capreolus/bert-base-msmarco, electra-base, or tiny (offline)"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh (fast approximation) or erf (exact HF parity)"),
        ConfigOption("allowrandominit", False, "allow random weights when the pretrained checkpoint cannot be loaded"),
        ConfigOption("aggregation", "max", "passage aggregation: max, first, sum, or avg"),
        ConfigOption("remat", False, "rematerialize encoder layers in the backward pass (not ported yet)"),
        ConfigOption("moeexperts", 0, "mixture-of-experts FFN: number of expert FFNs per layer "
                     "(0 = dense FFN; MoE is not ported yet)"),
        ConfigOption("moetopk", 2, "experts routed per token (top-k of the softmax gate)"),
        _QUANTIZE_OPT,
        _DROPOUT_OPT,
        _LORA_OPT,
        _LORA_ALPHA_OPT,
    ]


@Reranker.register
class PtBERTMaxPAlias(BERTMaxP):
    module_name = "ptBERTMaxP"


@Reranker.register
class TFBERTMaxPAlias(BERTMaxP):
    module_name = "TFBERTMaxP"


@Reranker.register
class VanillaBERT(BERTMaxP):
    """Single-passage BERT relevance classifier (the reference's TFVanillaBERT)."""

    module_name = "TFVanillaBERT"
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "pretrained model"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh (fast approximation) or erf (exact HF parity)"),
        ConfigOption("allowrandominit", False, "allow random weights when the pretrained checkpoint cannot be loaded"),
        ConfigOption("aggregation", "first", "single passage: always the first"),
        _QUANTIZE_OPT,
        _DROPOUT_OPT,
    ]
