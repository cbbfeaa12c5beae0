"""BERT/ELECTRA encoder for cross-encoder rerankers (the JAX package's
``reranker/bert/encoder.py``).

Embeddings, post-LN transformer layers and a tanh pooler, as ``nn.Module``s
whose parameter names follow the flax modules' (``layer_0.attention.query``,
``attention_ln``, ``intermediate``, ``ffn_output``, ``output_ln``, ``pooler``),
so that a flattened JAX param tree maps onto the ``state_dict`` name by name
(``convert.bert_state_dict``). Attention goes through
``ops.flash_attention.multihead_attention``: K2 on CUDA tensors.

The port computes in f32 with f32 LayerNorm statistics (eps 1e-12) and, by
default, the tanh GELU, as the JAX encoder does at its default dtype. With
``quantize="int8"`` (inference only) every projection and both FFN matmuls are
``Int8Linear``: per-token int8 quantization (Q1 on CUDA tensors,
``ops.quantization.quantize_tokens``), then an int8 x int8 product whose
epilogue dequantizes to f32 (``ops.int8_matmul.int8_linear_mm``) or, for the
FFN's up-projection outside calibration, applies GELU and requantizes to the
down-projection's int8 codes (``int8_linear_gelu_mm``); on CUDA tensors both
are epilogues of X1, so no int32 or f32 [tokens, intermediate] tensor reaches
device memory. Attention itself stays f32 through K2. Not in this slice:
``MoeFFN``, ``LoRAAdapter``, ``remat``, dropout and other dtypes; the
rerankers refuse the options that select them. Module init draws the
embeddings from N(0, 0.02) and leaves the linear layers at torch's default;
served weights come from a checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from capreolus_tpu_torch.ops import int8_matmul as x1
from capreolus_tpu_torch.ops.flash_attention import multihead_attention
from capreolus_tpu_torch.ops.quantization import int8_scale
from capreolus_tpu_torch.ops.quantization import quantize_tokens as _quantize_per_token
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
    quantize: str = "none"  # "int8": int8 projections and FFN matmuls at inference

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


class Int8Linear(nn.Linear):
    """``nn.Linear`` computed as an int8 x int8 -> int32 product (the JAX
    ``Int8Dense``), with ``nn.Linear``'s ``weight`` [out, in] and ``bias``, so
    state dicts load unchanged.

    The weight is quantized per output channel: ``ws = max(amax|w|, 1e-8) /
    127`` over the inputs, ``wq = round(w / ws)``, after multiplying each input
    channel by ``fold_scales`` when a pre-quantized input carries per-channel
    scales. The JAX module quantizes its kernel inside the graph on every call;
    here ``quantize_weight`` runs once, at the first forward after the weights
    load, and again when the fold changes (``BertLayer`` owns ``ffn_output``'s
    fold: ``requantize_ffn_output``). The codes and scales are the same values;
    they live in unsaved buffers (``weight_q``, ``weight_scale``).

    ``forward(x)`` quantizes x per token; ``forward(None, x_pre=q,
    x_scales=s)`` takes a quantized input, with per-token scales [..., 1], or
    none when its scales are folded into the weight. The output is ``acc *
    xs * ws + bias`` in f32, in that order (``int8_linear_mm``: X1's f32
    epilogue on CUDA tensors). ``gelu_codes`` returns, in place of that output,
    its GELU's int8 codes at per-channel scales (``int8_linear_gelu_mm``)."""

    def __init__(self, in_features, out_features):
        super().__init__(in_features, out_features)
        self.register_buffer("weight_q", None, persistent=False)
        self.register_buffer("weight_scale", None, persistent=False)

    def quantize_weight(self, fold_scales=None):
        with torch.no_grad():
            kf = self.weight.float()
            if fold_scales is not None:
                kf = kf * fold_scales[None, :]
            ws = int8_scale(kf.abs().amax(dim=1).clamp_min(1e-8))
            self.weight_q = torch.round(kf / ws[:, None]).to(torch.int8)
            self.weight_scale = ws

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.weight_q = self.weight_scale = None  # quantized again at the next forward

    def _operands(self, x, x_pre, x_scales):
        """(codes [tokens, in], scales [tokens] or None, leading shape)."""
        if x_pre is None:
            x_pre, x_scales = _quantize_per_token(x)
        if self.weight_q is None:
            self.quantize_weight()
        xs = None if x_scales is None else x_scales.reshape(-1)
        return x_pre.reshape(-1, x_pre.shape[-1]), xs, x_pre.shape[:-1]

    def forward(self, x, x_pre=None, x_scales=None):
        a, xs, lead = self._operands(x, x_pre, x_scales)
        return x1.int8_linear_mm(a, self.weight_q, self.weight_scale, self.bias, xs).view(*lead, -1)

    def gelu_codes(self, x, out_scales, approximate):
        """int8 codes of ``F.gelu(self(x), approximate)`` at per-output-channel
        ``out_scales``: round half to even, clipped to [-127, 127]."""
        a, xs, lead = self._operands(x, None, None)
        codes = x1.int8_linear_gelu_mm(a, self.weight_q, self.weight_scale, self.bias, out_scales, xs, approximate)
        return codes.view(*lead, -1)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        linear = Int8Linear if config.quantize == "int8" else nn.Linear
        self.query = linear(h, h)
        self.key = linear(h, h)
        self.value = linear(h, h)
        self.output = linear(h, h)

    def heads(self, hidden):
        """The projections split into heads: q, k, v [B, H, L, D] as views of
        the projections' [B, L, H * D] outputs (no copy: K2 reads the strides).
        With int8, one per-token quantization of ``hidden`` feeds all three
        projections."""
        c = self.config
        b, l, _ = hidden.shape

        def split(x):
            return x.view(b, l, c.num_heads, c.head_dim).transpose(1, 2)

        if c.quantize == "int8":
            hq, hs = _quantize_per_token(hidden)
            return tuple(split(p(None, x_pre=hq, x_scales=hs)) for p in (self.query, self.key, self.value))
        return split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))

    def forward(self, hidden, mask):
        b, l, h = hidden.shape
        out = multihead_attention(*self.heads(hidden), mask)
        # K2 writes its output [B, L, H, D] and returns the [B, H, L, D] view, so
        # on the card this merge of the heads is a view too
        return self.output(out.transpose(1, 2).reshape(b, l, h))


class BertLayer(nn.Module):
    """A post-LN transformer layer. With int8, the FFN is the JAX
    ``_int8_ffn``: int8 up-projection to f32, GELU, per-channel requantization
    with the ``gelu_amax`` buffer (the JAX ``quant_stats`` collection; 0 marks
    an uncalibrated channel, which takes amax = 8), and the down-projection with
    those scales folded into its weight. Outside calibration the up-projection
    returns the requantized codes themselves (``Int8Linear.gelu_codes``); a
    calibrating pass needs the f32 GELU output for its amax.

    The fold depends on ``gelu_amax``, so the layer requantizes ``ffn_output``
    whenever the stats change: when ``gelu_amax`` is assigned (calibration
    assigns it too) and after a ``load_state_dict`` that reaches the layer."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        linear = Int8Linear if config.quantize == "int8" else nn.Linear
        self.attention = BertSelfAttention(config)
        self.attention_ln = nn.LayerNorm(h, eps=eps)
        self.intermediate = linear(h, config.intermediate_size)
        self.ffn_output = linear(config.intermediate_size, h)
        self.output_ln = nn.LayerNorm(h, eps=eps)
        if config.quantize == "int8":
            self.register_buffer("gelu_amax", torch.zeros(config.intermediate_size))
            self.register_load_state_dict_post_hook(BertLayer._after_load)

    @staticmethod
    def _after_load(layer, incompatible_keys):
        """Runs once the layer and all its children have loaded."""
        layer.requantize_ffn_output()

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name == "gelu_amax":
            self.requantize_ffn_output()

    def requantize_ffn_output(self):
        """Quantize ``ffn_output``'s weight with the GELU scales folded in."""
        self.ffn_output.quantize_weight(fold_scales=self.gelu_scales())

    def forward(self, hidden, mask, calibrate=False):
        hidden = self.attention_ln(hidden + self.attention(hidden, mask))
        approximate = "tanh" if self.config.gelu_approximate else "none"
        if self.config.quantize == "int8":
            ff = self._int8_ffn(hidden, calibrate, approximate)
        else:
            ff = self.ffn_output(F.gelu(self.intermediate(hidden), approximate=approximate))
        return self.output_ln(hidden + ff)

    def gelu_scales(self):
        """Per-channel scales of the GELU output: amax / 127 (``int8_scale``), amax = 8 where uncalibrated."""
        return int8_scale(torch.where(self.gelu_amax > 0, self.gelu_amax, 8.0))

    def _int8_ffn(self, hidden, calibrate, approximate):
        if calibrate:
            g = F.gelu(self.intermediate(hidden), approximate=approximate)
            # the running max over every position of the batch, pad positions included
            observed = g.reshape(-1, g.shape[-1]).abs().amax(dim=0)
            self.gelu_amax = torch.maximum(self.gelu_amax, observed)  # requantizes ffn_output
            gq = x1.requantize(g, self.gelu_scales())
            del g
        else:  # GELU and its requantization in the up-projection's epilogue
            gq = self.intermediate.gelu_codes(hidden, self.gelu_scales(), approximate)
        if self.ffn_output.weight_q is None:  # a model whose weights never loaded
            self.requantize_ffn_output()
        return self.ffn_output(None, x_pre=gq)


class BertEncoder(nn.Module):
    """Returns (sequence_output, pooled_output). ``calibrate=True`` (int8 only)
    updates each layer's ``gelu_amax`` from this batch as it passes."""

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

    def forward(self, input_ids, attention_mask, token_type_ids, calibrate=False):
        hidden = self.embed(input_ids, token_type_ids)
        mask = attention_mask.bool()
        for i in range(self.config.num_layers):
            hidden = getattr(self, f"layer_{i}")(hidden, mask, calibrate)
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
