"""BERT cross-encoder rerankers (the JAX package's ``reranker/bert_rerankers.py``):
monoBERT-MaxP (``BERTMaxP``, Dai & Callan 2019) and the aliases of the
reference's configs (``ptBERTMaxP``, ``TFBERTMaxP``, ``TFVanillaBERT``).

Each passage of the ``bertpassage`` features goes through the encoder and a
linear relevance head, and a document's score aggregates its passages' scores
(max, first, sum or avg). ``score`` (pairs) and ``score_lce`` (a positive and
its negatives) are the training forwards: with a dropout seed the encoder
applies ``hidden_dropout_prob`` at both of its dropout sites and takes the
differentiable attention, and ``remat`` recomputes each layer in the backward
pass. Prediction (``test``) takes K2 on the card. With ``quantize=int8`` the
encoder runs its projections and FFN matmuls in int8 at prediction
(``reranker/bert/encoder.py``, X1 on the card), after ``prepare_inference``
has calibrated the GELU scales; training stays f32, as in JAX. PARADE,
CEDR-KNRM, Birch, LoRA, MoE and the pipeline views come with later slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder, load_pretrained_encoder

_QUANTIZE_OPT = ConfigOption(
    "quantize", "none",
    "inference-time quantization: none or int8 (int8 FFN matmuls on the v5e MXU double-rate path; training stays bf16/f32)")
_DROPOUT_OPT = ConfigOption("hidden_dropout_prob", 0.1, "dropout probability of the encoder's hidden layers "
                            "during training (no effect at inference)")
_LORA_OPT = ConfigOption("lora", 0, "LoRA rank: 0 = full model (LoRA adapters are not ported yet)",
                         value_type="int")
_LORA_ALPHA_OPT = ConfigOption("loraalpha", 16.0, "LoRA scaling alpha (delta = alpha/r * BA x)")

# options whose non-default values select code this slice does not port
_UNPORTED = (
    ("moeexperts", lambda v: v > 0, "the mixture-of-experts FFN; ROADMAP.md item 6, 'the other BERT rerankers'"),
    ("lora", lambda v: v > 0, "LoRA adapters; ROADMAP.md item 4, what the trainer slice leaves"),
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

    def forward(self, inp, mask, seg, calibrate=False, dropout_seed=None):
        flat_inp, flat_mask, flat_seg, b, p = _flatten_passages(inp, mask, seg)
        _, pooled = self.bert(flat_inp, flat_mask, flat_seg, calibrate=calibrate, dropout_seed=dropout_seed)
        return self.classifier(pooled.float())[:, 0].reshape(b, p)


class BertRerankerBase(Reranker):
    """Common scoring plumbing for cross-encoders over bertpassage features."""

    dependencies = [
        Dependency(key="extractor", module="extractor", name="bertpassage"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    accepts_rngs = True  # the trainer hands training forwards a dropout seed

    def build(self):
        if self.config.get("quantize") not in (None, "none", "int8"):  # "none" casts to None
            raise ConfigError(f"{self.module_name}: quantize must be 'none' or 'int8', got {self.config['quantize']!r}")
        if self.quantized and int(self.config.get("moeexperts", 0) or 0) > 0:
            raise ConfigError("moeexperts and quantize=int8 cannot be combined")
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
        cfg = dataclasses.replace(cfg, gelu_approximate=self.config.get("gelu", "tanh") == "tanh",
                                  quantize="int8" if self.quantized else "none",
                                  remat=bool(self.config.get("remat", False)))
        hdp = self.config.get("hidden_dropout_prob")
        if hdp is not None:  # one knob sets both dropout sites, as in JAX
            cfg = dataclasses.replace(cfg, hidden_dropout_prob=float(hdp), attention_dropout_prob=float(hdp))
        return cfg

    @property
    def quantized(self) -> bool:
        return self.config.get("quantize") == "int8"

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = _BertScorer(self.encoder_config())
        return self.model

    def state_dict_from_params(self, flat):
        """The model's state_dict from flat JAX variables: ``params/...`` and,
        for an int8 model, ``quant_stats/bert/layer_i/gelu_amax`` where the
        checkpoint carries them. Stats it lacks start at 0 (uncalibrated)."""
        from capreolus_tpu_torch.convert import bert_state_dict

        state = bert_state_dict(flat)
        for name, buf in self.build_model().named_buffers():
            if name.endswith("gelu_amax"):
                state.setdefault(name, torch.zeros_like(buf))
        return state

    def prepare_inference(self, batch, device):
        """Calibrate the int8 activation scales on a sample batch (a no-op
        unless quantize=int8), as the JAX ``prepare_inference`` does: every
        layer's ``gelu_amax`` restarts at 0 and takes the max of |GELU| over
        every position of the batch in one forward pass, each layer seeing the
        output of the layers already calibrated. The stats are buffers of the
        model, so there is no separate variables object to hand to ``test``
        (the JAX ``inference_variables``); a model never calibrated takes
        amax = 8 in every channel, the JAX fallback for zero stats."""
        if not self.quantized:
            return
        model = self.build_model()
        if hasattr(self, "_train_model"):  # the trained weights, requantized as they load
            model.to(device).load_state_dict(self._train_model.state_dict(), strict=False)

        def put(key):
            return torch.from_numpy(np.asarray(batch[key])).to(device)

        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith("gelu_amax"):
                    model.get_submodule(name.rsplit(".", 1)[0]).gelu_amax = torch.zeros_like(buf)
            model(put("pos_bert_input"), put("pos_mask"), put("pos_seg"), calibrate=True)

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

    def build_train_model(self):
        """The model the trainer trains: ``build_model()``'s, or with
        ``quantize=int8`` an f32 model of the same weights (int8 is
        inference-only, as in JAX); ``prepare_inference`` copies its weights
        into the int8 model before it calibrates."""
        if not self.quantized:
            return self.build_model()
        if not hasattr(self, "_train_model"):
            self._train_model = _BertScorer(dataclasses.replace(self.encoder_config(), quantize="none"))
        return self._train_model

    def _score_doc(self, inp, mask, seg, dropout_seed=None):
        """[B] document scores; a ``dropout_seed`` makes it a training forward."""
        model = self.model if dropout_seed is None else self.build_train_model()
        return self._head_scores(model(inp, mask, seg, dropout_seed=dropout_seed), mask)

    @staticmethod
    def fold_seed(dropout_seed, i):
        """Distinct dropout streams for the pos / neg (or LCE group) forwards."""
        if dropout_seed is None:
            return None
        from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

        return dropout_generator_seed(dropout_seed, 1000 + i)

    def _inputs(self, batch, side, device):
        """(input ids, mask, segment ids) of the batch's ``side`` ("pos" or "neg") on ``device``."""
        return tuple(self.put(batch, f"{side}_{key}", device) for key in ("bert_input", "mask", "seg"))

    def score(self, batch, device, dropout_seed=None):
        return [self._score_doc(*self._inputs(batch, side, device), dropout_seed=self.fold_seed(dropout_seed, i))
                for i, side in enumerate(("pos", "neg"))]

    def score_lce(self, batch, device, dropout_seed=None):
        """[B, 1+nneg] group scores: the positive followed by each negative."""
        pos = self._score_doc(*self._inputs(batch, "pos", device), dropout_seed=self.fold_seed(dropout_seed, 0))
        negs, masks, segs = self._inputs(batch, "neg", device)
        neg_scores = [self._score_doc(negs[:, i], masks[:, i], segs[:, i], dropout_seed=self.fold_seed(dropout_seed, i + 1))
                      for i in range(negs.shape[1])]
        return torch.stack([pos] + neg_scores, dim=1)

    def test(self, batch, device):
        return self._score_doc(*self._inputs(batch, "pos", device))


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
        ConfigOption("remat", False, "rematerialize encoder layers in the backward pass"),
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
