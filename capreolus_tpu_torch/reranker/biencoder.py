"""Trainable dense bi-encoder (DPR/TCT-ColBERT-style): the JAX package's
``reranker/biencoder.py``.

A shared BERT encoder embeds the query and the document separately (mean or
CLS pooling, L2-normalised); the score is ``scale`` times their cosine. It
trains with the port's trainer over the ``berttext`` extractor
(``specialtokens=True``, the ``[CLS] ... [SEP]`` layout the dense searcher
serves): with the pairwise losses through ``score``, or with
``trainer.loss=infonce`` through ``encode``, which embeds each text once for
the trainer's in-batch similarity matrix. A training forward draws dropout
from seeds of its own for the query and each document side (site 0, 1, 2 of
``encode``, as the JAX ``encode`` folds its rngs), through ``attention_plain``;
a prediction goes through K2 on the card. Its ``dev.best`` (``params/bert/...``)
is the ``dense`` searcher's ``checkpointfile`` in either package.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder, load_pretrained_encoder
from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


def _seed(dropout_seed, i):
    return None if dropout_seed is None else dropout_generator_seed(dropout_seed, i)


def encoder_inputs(toks, max_position):
    """[B, L] ids truncated to BERT's learned positions (HF's truncation) and
    the [PAD] = 0 mask, as the JAX models build them."""
    toks = torch.as_tensor(toks).long()[:, :max_position]
    return toks, (toks != 0).to(torch.int32)


class BiEncoderModel(nn.Module):
    """Shared-encoder bi-encoder: score = scale * cos(embed(q), embed(d))."""

    def __init__(self, config: BertConfig, pooling: str = "mean", scale: float = 20.0):
        super().__init__()
        self.config = config
        self.pooling = pooling
        self.scale = scale
        self.bert = BertEncoder(config)

    def embed(self, toks, dropout_seed=None):
        """L2-normalized pooled embedding of one token batch ([B, L] -> [B, H])."""
        toks, mask = encoder_inputs(toks, self.config.max_position)
        hidden, _ = self.bert(toks, mask, torch.zeros_like(toks), dropout_seed=dropout_seed)
        if self.pooling == "cls":
            vec = hidden[:, 0]
        else:
            m = mask[..., None].to(hidden.dtype)
            vec = (hidden * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)
        vec = vec.float()
        return vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + 1e-9)

    def forward(self, querytoks, doctoks, query_idf=None, dropout_seed=None):
        q = self.embed(querytoks, _seed(dropout_seed, 0))
        d = self.embed(doctoks, _seed(dropout_seed, 1))
        return self.scale * (q * d).sum(dim=-1)


class BertRetrieverBase(Reranker):
    """What the three retrieval rerankers share: the ``berttext`` extractor,
    dropout during training, the pretrained encoder over ``bert``, and the
    state dict from a flat JAX param tree."""

    dependencies = [
        # specialtokens: train on the same [CLS] ... [SEP] layout the searchers serve
        Dependency(key="extractor", module="extractor", name="berttext",
                   default_config_overrides={"specialtokens": True}),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    accepts_rngs = True  # encoder dropout during training

    def build(self):
        if self.config["gelu"] not in ("tanh", "erf"):
            raise ConfigError(f"{self.module_name} gelu must be 'tanh' or 'erf', got {self.config['gelu']!r}")

    def encoder_config(self):
        """The encoder's config with the options' GELU and dropout rates; reads
        the pretrained weights once (``_pretrained_state``)."""
        cfg, self._pretrained_state = load_pretrained_encoder(
            self.config["pretrained"], allow_random_init=bool(self.config["allowrandominit"]))
        rate = float(self.config["hidden_dropout_prob"])
        return dataclasses.replace(cfg, gelu_approximate=self.config["gelu"] == "tanh",
                                   hidden_dropout_prob=rate, attention_dropout_prob=rate)

    def _load_pretrained(self, model):
        if self._pretrained_state is not None:
            model.bert.load_state_dict(self._pretrained_state)
            logger.info("loaded pretrained weights into the %s encoder", self.module_name)

    def init_params(self, seed: int) -> nn.Module:
        """flax's initial draws, then the pretrained encoder over ``bert``, as
        the JAX ``init_params`` replaces that subtree."""
        model = super().init_params(seed)
        self._load_pretrained(model)
        return model

    def state_dict_from_params(self, flat, model=None):
        from capreolus_tpu_torch.convert import bert_state_dict

        return bert_state_dict(flat)

    score = Reranker.score_default
    test = Reranker.test_default


@Reranker.register
class BiEncoder(BertRetrieverBase):
    """Dense retriever trained in-framework; export to the dense searcher."""

    module_name = "biencoder"
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "encoder checkpoint (or 'tiny' offline)"),
        ConfigOption("pooling", "mean", "embedding pooling: mean or cls"),
        ConfigOption("scale", 20.0, "cosine similarity scale (logit temperature)"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh or erf"),
        ConfigOption("allowrandominit", False, "allow random init when the checkpoint cannot be loaded"),
        ConfigOption("hidden_dropout_prob", 0.1, "encoder dropout during training"),
    ]

    def build(self):
        if self.config["pooling"] not in ("mean", "cls"):
            raise ConfigError(f"biencoder pooling must be 'mean' or 'cls', got {self.config['pooling']!r}")
        super().build()

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = BiEncoderModel(self.encoder_config(), pooling=self.config["pooling"],
                                        scale=float(self.config["scale"]))
            self._load_pretrained(self.model)
        return self.model

    def encode(self, batch, device, dropout_seed=None):
        """(q, posdoc, negdoc-or-None) unit embeddings [B, H] and the logit
        scale, for the trainer's in-batch-negative InfoNCE loss; each text is
        encoded once, with the dropout seed of its site (0, 1, 2)."""
        model = self.model
        q = model.embed(self.put(batch, "query", device), _seed(dropout_seed, 0))
        pos = model.embed(self.put(batch, "posdoc", device), _seed(dropout_seed, 1))
        neg = model.embed(self.put(batch, "negdoc", device), _seed(dropout_seed, 2)) if "negdoc" in batch else None
        return q, pos, neg, float(self.config["scale"])
