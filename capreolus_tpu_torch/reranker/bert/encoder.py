"""BERT/ELECTRA encoder for cross-encoder rerankers (the JAX package's
``reranker/bert/encoder.py``).

Embeddings, post-LN transformer layers and a tanh pooler, as ``nn.Module``s
whose parameter names follow the flax modules' (``layer_0.attention.query``,
``attention_ln``, ``intermediate``, ``ffn_output``, ``output_ln``, ``pooler``),
so that a flattened JAX param tree maps onto the ``state_dict`` name by name
(``convert.bert_state_dict``). Attention goes through
``ops.flash_attention.multihead_attention``: K2 on CUDA tensors.

The port computes in f32 with f32 LayerNorm statistics (eps 1e-12) and, by
default, the tanh GELU, as the JAX encoder does at its default dtype. Not in
this slice: the int8 path (``Int8Dense``), ``MoeFFN``, ``LoRAAdapter``,
``remat``, dropout and other dtypes; the rerankers refuse the options that
select them. Module init draws the embeddings from N(0, 0.02) and leaves the
linear layers at torch's default; served weights come from a checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from capreolus_tpu_torch.ops.flash_attention import multihead_attention
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    gelu_approximate: bool = True  # tanh GELU; False for erf

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


# named configs of the reference (ELECTRA discriminators share BERT's encoder shape)
KNOWN_CONFIGS = {
    "tiny": BertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2,
                       intermediate_size=128, max_position=512),
    "bert-base-uncased": BertConfig(),
    "Capreolus/bert-base-msmarco": BertConfig(),
    "bert-large-uncased": BertConfig(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096),
    "google/electra-base-discriminator": BertConfig(),
    "Capreolus/electra-base-msmarco": BertConfig(),
    "Capreolus/birch-bert-large-mb": BertConfig(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096),
    "Capreolus/birch-bert-large-msmarco_mb": BertConfig(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096),
    "Capreolus/birch-bert-large-car_mb": BertConfig(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096),
}

# short model names of the reference's configs, mapped to hub checkpoint names
PRETRAINED_ALIASES = {
    "electra-base": "google/electra-base-discriminator",
    "electra-base-msmarco": "Capreolus/electra-base-msmarco",
    "bert-base-msmarco": "Capreolus/bert-base-msmarco",
    "mb": "Capreolus/birch-bert-large-mb",
    "msmarco_mb": "Capreolus/birch-bert-large-msmarco_mb",
    "car_mb": "Capreolus/birch-bert-large-car_mb",
}


def get_bert_config(name: str) -> BertConfig:
    name = PRETRAINED_ALIASES.get(name, name)
    return KNOWN_CONFIGS.get(name, BertConfig())


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output = nn.Linear(h, h)

    def heads(self, hidden):
        """The projections split into heads: q, k, v [B, H, L, D], contiguous
        (the layout K2 reads)."""
        c = self.config
        b, l, _ = hidden.shape

        def split(x):
            return x.view(b, l, c.num_heads, c.head_dim).transpose(1, 2).contiguous()

        return split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))

    def forward(self, hidden, mask):
        b, l, h = hidden.shape
        out = multihead_attention(*self.heads(hidden), mask)
        return self.output(out.transpose(1, 2).reshape(b, l, h))


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(config)
        self.attention_ln = nn.LayerNorm(h, eps=eps)
        self.intermediate = nn.Linear(h, config.intermediate_size)
        self.ffn_output = nn.Linear(config.intermediate_size, h)
        self.output_ln = nn.LayerNorm(h, eps=eps)

    def forward(self, hidden, mask):
        hidden = self.attention_ln(hidden + self.attention(hidden, mask))
        approximate = "tanh" if self.config.gelu_approximate else "none"
        ff = self.ffn_output(F.gelu(self.intermediate(hidden), approximate=approximate))
        return self.output_ln(hidden + ff)


class BertEncoder(nn.Module):
    """Returns (sequence_output, pooled_output)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.word_embeddings = nn.Parameter(torch.randn(config.vocab_size, h) * 0.02)
        self.position_embeddings = nn.Parameter(torch.randn(config.max_position, h) * 0.02)
        self.token_type_embeddings = nn.Parameter(torch.randn(config.type_vocab_size, h) * 0.02)
        self.embeddings_ln = nn.LayerNorm(h, eps=config.layer_norm_eps)
        for i in range(config.num_layers):
            self.add_module(f"layer_{i}", BertLayer(config))
        self.pooler = nn.Linear(h, h)

    def embed(self, input_ids, token_type_ids):
        """Embedding sum + LayerNorm [B, L, H]. Ids are taken mod the vocab
        sizes, as in the JAX encoder (identity for real checkpoints; keeps the
        hash-vocab fallback in range for small configs)."""
        c = self.config
        hidden = (self.word_embeddings[input_ids % c.vocab_size]
                  + self.position_embeddings[None, : input_ids.shape[1]]
                  + self.token_type_embeddings[token_type_ids % c.type_vocab_size])
        return self.embeddings_ln(hidden)

    def forward(self, input_ids, attention_mask, token_type_ids):
        hidden = self.embed(input_ids, token_type_ids)
        mask = attention_mask.bool()
        for i in range(self.config.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, mask)
        return hidden, torch.tanh(self.pooler(hidden[:, 0]))


# ------------------------------------------------------------------ HF weight loading
def convert_hf_weights(state_dict, config: BertConfig) -> dict:
    """A HuggingFace BERT/ELECTRA state_dict (``bert.``, ``electra.`` or no
    prefix) as a ``BertEncoder`` state_dict. torch's Linear layout [out, in]
    is kept; an ELECTRA checkpoint has no pooler, which then starts as the
    identity with a zero bias, as in the JAX function."""

    def get(*names):
        for name in names:
            if name in state_dict:
                return state_dict[name]
        raise KeyError(f"none of {names} in checkpoint (keys like {list(state_dict)[:5]})")

    def prefixed(suffix):
        return (f"bert.{suffix}", f"electra.{suffix}", suffix)

    out = {
        "word_embeddings": get(*prefixed("embeddings.word_embeddings.weight")),
        "position_embeddings": get(*prefixed("embeddings.position_embeddings.weight")),
        "token_type_embeddings": get(*prefixed("embeddings.token_type_embeddings.weight")),
        "embeddings_ln.weight": get(*prefixed("embeddings.LayerNorm.weight")),
        "embeddings_ln.bias": get(*prefixed("embeddings.LayerNorm.bias")),
    }
    per_layer = (
        ("attention.query", "attention.self.query"),
        ("attention.key", "attention.self.key"),
        ("attention.value", "attention.self.value"),
        ("attention.output", "attention.output.dense"),
        ("attention_ln", "attention.output.LayerNorm"),
        ("intermediate", "intermediate.dense"),
        ("ffn_output", "output.dense"),
        ("output_ln", "output.LayerNorm"),
    )
    for i in range(config.num_layers):
        for ours, theirs in per_layer:
            for leaf in ("weight", "bias"):
                out[f"layer_{i}.{ours}.{leaf}"] = get(*prefixed(f"encoder.layer.{i}.{theirs}.{leaf}"))
    try:
        out["pooler.weight"] = get(*prefixed("pooler.dense.weight"))
        out["pooler.bias"] = get(*prefixed("pooler.dense.bias"))
    except KeyError:
        out["pooler.weight"] = np.eye(config.hidden_size, dtype=np.float32)
        out["pooler.bias"] = np.zeros(config.hidden_size, dtype=np.float32)
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in out.items()}


def load_pretrained_encoder(name: str, allow_random_init: bool = False):
    """Returns (BertConfig, None): the port reads no pretrained checkpoint and
    never downloads one, so every model starts from random init and takes its
    weights from a serving checkpoint. ``tiny`` is the deliberate random-init
    config; any other name raises unless ``allow_random_init=True``, with the
    JAX function's message (a run that claims a pretrained name must not
    silently use random weights)."""
    name = PRETRAINED_ALIASES.get(name, name)
    config = get_bert_config(name)
    if name == "tiny":
        return config, None
    reason = "the PyTorch port reads no pretrained checkpoint files yet and never downloads"
    if not allow_random_init:
        raise RuntimeError(
            f"could not load pretrained weights for {name!r} ({reason}); refusing to "
            f"continue with random initialization. Fix the model name / provide a "
            f"cached checkpoint, use pretrained=tiny for offline smoke tests, or "
            f"opt in explicitly with reranker.allowrandominit=True"
        )
    logger.warning("could not load pretrained %s (%s); using random initialization "
                   "(allowrandominit=True)", name, reason)
    return config, None
