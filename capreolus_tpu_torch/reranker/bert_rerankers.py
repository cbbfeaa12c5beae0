"""BERT cross-encoder rerankers (the JAX package's ``reranker/bert_rerankers.py``):
monoBERT-MaxP (``BERTMaxP``, Dai & Callan 2019) with the aliases of the
reference's configs (``ptBERTMaxP``, ``TFBERTMaxP``, ``TFVanillaBERT``),
PARADE (``parade`` / ``ptparade``, Li et al. 2020), CEDR-KNRM (``CEDRKNRM`` /
``TFCEDRKNRM``, MacAvaney et al. 2019) and Birch (``birch``, Yilmaz et al.
2019).

Each passage of the ``bertpassage`` features goes through the encoder. BERTMaxP
scores each passage with a linear head and aggregates a document's passage
scores (max, first, sum or avg); PARADE aggregates the passages' CLS vectors
(max, mean, or two transformer layers over them); CEDR-KNRM pools RBF kernels
over the cosine similarities of every chosen layer's hidden states, plus the
CLS vectors; Birch combines a document's top-k passage scores. ``score``
(pairs) and ``score_lce`` (a positive and its negatives) are the training
forwards: with a dropout seed the encoder applies ``hidden_dropout_prob`` at
both of its dropout sites and takes the differentiable attention, and
``remat`` recomputes each layer in the backward pass. Prediction (``test``)
takes K2 on the card. With ``quantize=int8`` the encoder (and PARADE's
aggregation layers) runs its projections and FFN matmuls in int8 at
prediction (``reranker/bert/encoder.py``, X1 and Q1 on the card), after
``prepare_inference`` has calibrated the GELU scales; training stays f32, as
in JAX. ``moeexperts > 0`` gives every encoder layer a mixture-of-experts FFN.
A pretrained checkpoint (``pretrained``) is read from a local directory or the
Hugging Face hub cache and loaded into the encoder; Birch also loads its NSP
head. ``lora > 0`` (BERTMaxP and its aliases) adds rank-r adapters to every
attention's query and value projections and freezes the rest of the encoder:
the optimizer holds the adapters and the head, and ``dev.best`` holds them
alone, the frozen leaves empty; serving fills those from the pretrained
encoder (``state_dict_from_params``). The pipeline views are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder, read_pretrained
from capreolus_tpu_torch.reranker.bert.encoder import BertLayer, dropout_generator_seed, set_quant_dtype
from capreolus_tpu_torch.reranker.common import rbf_kernel_bank
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

_QUANTIZE_OPT = ConfigOption(
    "quantize", "none",
    "inference-time quantization: none or int8 (int8 FFN matmuls on the v5e MXU double-rate path; training stays bf16/f32)")
_DROPOUT_OPT = ConfigOption("hidden_dropout_prob", 0.1, "dropout probability of the encoder's hidden layers "
                            "during training (no effect at inference)")
_LORA_OPT = ConfigOption(
    "lora", 0,
    "LoRA rank: 0 = full fine-tuning; r > 0 adds rank-r adapters to the attention "
    "query/value projections, FREEZES the base encoder (checkpoints and optimizer "
    "state shrink to adapters + head), and starts exactly at the pretrained model "
    "(zero-init up-projection)", value_type="int")
_LORA_ALPHA_OPT = ConfigOption("loraalpha", 16.0, "LoRA scaling alpha (delta = alpha/r * BA x)")
# dropout sites of PARADE's aggregation layers: path entries no encoder layer takes (those take 1..num_layers)
PARADE_AGG_DROPOUT_SITE = 1 << 20


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
    """Common scoring plumbing for cross-encoders over bertpassage features.

    A subclass builds its model in ``_make_model(config)``; ``build_model``
    (the model ``test`` runs) and ``build_train_model`` (an f32 copy of an
    int8 reranker's) both go through it, and both load the pretrained encoder
    when one was read."""

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
        gelu = self.config.get("gelu", "tanh")
        if gelu not in ("tanh", "erf"):
            raise ValueError(f"gelu must be 'tanh' or 'erf', got {gelu!r}")

    def encoder_config(self) -> BertConfig:
        """The encoder's config: the pretrained checkpoint's (read once, its
        weights and NSP head kept for ``_load_pretrained``) with this reranker's GELU,
        quantization, remat, dropout, LoRA and MoE options, and the JAX package's
        two refusals of MoE."""
        if getattr(self, "_encoder_config", None) is not None:
            return self._encoder_config
        cfg, self._pretrained_state, self._pretrained_nsp_head = read_pretrained(
            self.config["pretrained"], allow_random_init=bool(self.config.get("allowrandominit", False)))
        cfg = dataclasses.replace(cfg, gelu_approximate=self.config.get("gelu", "tanh") == "tanh",
                                  quantize="int8" if self.quantized else "none",
                                  remat=bool(self.config.get("remat", False)))
        hdp = self.config.get("hidden_dropout_prob")
        if hdp is not None:  # one knob sets both dropout sites, as in JAX
            cfg = dataclasses.replace(cfg, hidden_dropout_prob=float(hdp), attention_dropout_prob=float(hdp))
        lora = int(self.config.get("lora", 0) or 0)
        if lora:
            cfg = dataclasses.replace(cfg, lora_rank=lora, lora_alpha=float(self.config.get("loraalpha", 16.0)))
        moe = int(self.config.get("moeexperts", 0) or 0)
        if moe:
            if self.quantized:
                raise ConfigError("moeexperts and quantize=int8 cannot be combined")
            if self._pretrained_state is not None:
                raise ConfigError("moeexperts>0 replaces the FFN weights and cannot load a dense "
                                  "pretrained checkpoint; use pretrained=tiny or allowrandominit")
            cfg = dataclasses.replace(cfg, moe_experts=moe, moe_topk=int(self.config.get("moetopk", 2)))
        self._encoder_config = cfg
        return cfg

    @property
    def quantized(self) -> bool:
        return self.config.get("quantize") == "int8"

    def _make_model(self, config: BertConfig) -> nn.Module:
        return _BertScorer(config)

    def _load_pretrained(self, model):
        """Copy the pretrained encoder weights, when a checkpoint was read,
        into ``model.bert``; the int8 stats buffers and the LoRA adapters,
        which only the model has, keep their values (the JAX ``_merge_params``)."""
        state = getattr(self, "_pretrained_state", None)
        if state is None:
            return
        missing, unexpected = model.bert.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("gelu_amax") and "_lora." not in k]
        if missing or unexpected:
            raise KeyError(f"the pretrained encoder does not fit the model: missing {missing[:3]}, "
                           f"unexpected {unexpected[:3]}")
        logger.info("loaded pretrained weights into the bert submodule")

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = self._make_model(self.encoder_config())
            self._load_pretrained(self.model)
        return self.model

    def init_params(self, seed: int) -> nn.Module:
        """The training model with flax's initial draws (``Reranker.init_params``),
        then the pretrained encoder over them, as the JAX ``init_params`` merges
        it into its initialised tree."""
        model = super().init_params(seed)
        self._load_pretrained(model)
        return model

    def state_dict_from_params(self, flat, model=None):
        """``model``'s state_dict (``build_model()``'s by default) from flat JAX
        variables: ``params/...`` and, for an int8 model,
        ``quant_stats/.../gelu_amax`` where the checkpoint carries them. Stats
        it lacks start at 0 (uncalibrated). A frozen parameter (``trainable``)
        that it lacks or leaves empty keeps ``model``'s own value, as the JAX
        ``_merge_frozen`` keeps it (Birch's frozen encoder and NSP head); a
        trainable one it lacks raises KeyError."""
        from capreolus_tpu_torch.convert import _present, bert_state_dict, flax_leaves

        model = self.build_model() if model is None else model
        state = bert_state_dict({k: v for k, v in flat.items() if _present(flat, k)})
        own, params = model.state_dict(), dict(model.named_parameters())
        missing = []
        for key, name, *_ in flax_leaves(model):
            if name not in state:
                if self.trainable(tuple(key.split("/")), params[name]):
                    missing.append(key)
                else:
                    state[name] = own[name]
        if missing:
            raise KeyError(f"the checkpoint lacks trainable parameters {missing[:3]}")
        for name, buf in model.named_buffers():
            if name.endswith("gelu_amax"):
                state.setdefault(name, torch.zeros_like(buf))
        return state

    def trainable(self, path, value):
        """With LoRA on, only the adapters and everything outside the encoder
        (the head, ...) train; the base encoder is frozen: no gradient, no
        optimizer state, empty in checkpoints."""
        if int(self.config.get("lora", 0) or 0) > 0:
            name = "/".join(map(str, path))
            if "bert" in name and "lora" not in name:
                return False
        return True

    def _shape_inputs(self, inp, mask, seg):
        """Inputs as the model takes them (models over [B, P, L] override)."""
        return inp, mask, seg

    def prepare_inference(self, batch, device):
        """Calibrate the int8 activation scales on a sample batch (a no-op
        unless quantize=int8), as the JAX ``prepare_inference`` does: every
        layer's ``gelu_amax`` (PARADE's aggregation layers' included)
        restarts at 0 and takes the max of |GELU| over every position of the
        batch in one forward pass, each layer seeing the output of the layers
        already calibrated. The stats are buffers of the model, so there is no
        separate variables object to hand to ``test`` (the JAX
        ``inference_variables``); a model never calibrated takes amax = 8 in
        every channel, the JAX fallback for zero stats."""
        if not self.quantized:
            return
        model = self.build_model()
        set_quant_dtype(model, torch.float32)  # trainer.amp's predictions quantize in bf16
        if hasattr(self, "_train_model"):  # the trained weights, requantized as they load
            model.to(device).load_state_dict(self._train_model.state_dict(), strict=False)

        def put(key):
            return torch.from_numpy(np.asarray(batch[key])).to(device)

        with torch.no_grad():
            for name, buf in model.named_buffers():
                if name.endswith("gelu_amax"):
                    model.get_submodule(name.rsplit(".", 1)[0]).gelu_amax = torch.zeros_like(buf)
            model(*self._shape_inputs(put("pos_bert_input"), put("pos_mask"), put("pos_seg")), calibrate=True)

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
            self._train_model = self._make_model(dataclasses.replace(self.encoder_config(), quantize="none"))
            self._load_pretrained(self._train_model)
        return self._train_model

    def _score_doc(self, inp, mask, seg, dropout_seed=None):
        """[B] document scores; a ``dropout_seed`` makes it a training forward."""
        model = self.model if dropout_seed is None else self.build_train_model()
        inp, mask, seg = self._shape_inputs(inp, mask, seg)
        return self._head_scores(model(inp, mask, seg, dropout_seed=dropout_seed), mask)

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


class _PooledReranker(BertRerankerBase):
    """A reranker whose model takes a document's passages together, [B, P, L],
    and returns its score as [B, 1]."""

    def _shape_inputs(self, inp, mask, seg):
        if inp.dim() == 2:  # a single passage is still a document
            inp, mask, seg = inp[:, None], mask[:, None], seg[:, None]
        return inp, mask, seg

    def _head_scores(self, raw_scores, mask):
        return raw_scores[:, 0]  # the model already aggregated its passages


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
                     "(0 = dense FFN; top-k softmax routing, dense dispatch)"),
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


# ---------------------------------------------------------------- PARADE
class ParadeModel(nn.Module):
    """PARADE's model: the encoder's pooled CLS vector of every passage,
    aggregated into one document vector (``maxp``: the max over passages;
    ``avg``: the mean; ``transformer``: a learned ``agg_cls`` vector put
    before the passages' vectors, ``passage_position_embeddings`` [P + 1, H]
    added, and two ``BertLayer``s, ``agg_layer_0`` and ``agg_layer_1``, over
    them with every position unmasked, whose first output is the document
    vector), then a linear ``classifier``. Returns [B, 1].

    In a training forward the aggregation layers draw their dropout at sites
    of their own (``PARADE_AGG_DROPOUT_SITE + i``), never an encoder layer's."""

    def __init__(self, config: BertConfig, aggregation: str = "transformer", num_passages: int = 16):
        super().__init__()
        if aggregation not in ("transformer", "maxp", "avg"):
            raise ValueError(f"unknown PARADE aggregation {aggregation!r}")
        self.config = config
        self.aggregation = aggregation
        h = config.hidden_size
        self.bert = BertEncoder(config)
        if aggregation == "transformer":
            self.passage_position_embeddings = nn.Parameter(torch.zeros(num_passages + 1, h))
            self.agg_cls = nn.Parameter(torch.zeros(h))
            self.agg_layer_0 = BertLayer(config)
            self.agg_layer_1 = BertLayer(config)
        self.classifier = nn.Linear(h, 1)

    def flax_init_(self, generator: torch.Generator):
        """The passage position embeddings and ``agg_cls`` N(0, 0.02), as flax draws them."""
        if self.aggregation == "transformer":
            with torch.no_grad():
                self.passage_position_embeddings.normal_(0.0, 0.02, generator=generator)
                self.agg_cls.normal_(0.0, 0.02, generator=generator)

    def forward(self, inp, mask, seg, calibrate=False, dropout_seed=None):
        flat_inp, flat_mask, flat_seg, b, p = _flatten_passages(inp, mask, seg)
        _, pooled = self.bert(flat_inp, flat_mask, flat_seg, calibrate=calibrate, dropout_seed=dropout_seed)
        cls_vecs = pooled.reshape(b, p, -1).float()  # [B, P, H]
        if self.aggregation == "maxp":
            doc_vec = cls_vecs.amax(dim=1)
        elif self.aggregation == "avg":
            doc_vec = cls_vecs.mean(dim=1)
        else:
            h = cls_vecs.shape[-1]
            x = torch.cat([self.agg_cls.expand(b, 1, h), cls_vecs], dim=1) + self.passage_position_embeddings[None, :p + 1]
            full_mask = torch.ones((b, p + 1), dtype=torch.bool, device=x.device)
            for i in range(2):
                seed = None if dropout_seed is None else dropout_generator_seed(dropout_seed, PARADE_AGG_DROPOUT_SITE + i)
                x = getattr(self, f"agg_layer_{i}")(x, full_mask, calibrate, seed)
            doc_vec = x[:, 0].float()
        return self.classifier(doc_vec)[:, :1]


@Reranker.register
class Parade(_PooledReranker):
    """PARADE: Passage Representation Aggregation for Document Reranking (Li et al. 2020)."""

    module_name = "parade"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="pooledbertpassage"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "pretrained model"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh (fast approximation) or erf (exact HF parity)"),
        ConfigOption("allowrandominit", False, "allow training from random weights when the pretrained checkpoint cannot be loaded"),
        ConfigOption("aggregation", "transformer", "passage aggregation: transformer, maxp, or avg"),
        _QUANTIZE_OPT,
        _DROPOUT_OPT,
    ]

    def _make_model(self, config):
        return ParadeModel(config, aggregation=self.config["aggregation"],
                           num_passages=self.extractor.config["numpassages"])


@Reranker.register
class PtParadeAlias(Parade):
    module_name = "ptparade"


# ---------------------------------------------------------------- CEDR-KNRM
class CedrKnrmModel(nn.Module):
    """CEDR-KNRM's model: KNRM over the cosine similarities of the encoder's
    hidden states at each layer of ``simmat_layers`` (0 is the embedding
    output), plus the passages' CLS vectors.

    Query tokens are segment 0, unmasked and at positions 1..maxqlen; document
    tokens segment 1 and unmasked; every other entry of a passage's [L, L]
    similarity matrix is 0. A document's passages are laid side by side into
    one [L, P * L] matrix. Each RBF kernel (the configured ``mus`` with
    ``sigma``, and an exact-match kernel, mu 1.0 and sigma 0.01, appended) is
    summed over the document axis, and its log (at least 1e-10) times 0.01
    summed over the query rows that have any nonzero similarity. With
    ``gradkernels`` the mus and sigmas are trained parameters (``mus``,
    ``sigmas``); else constants. ``cls`` appends the passages' pooled vectors'
    mean (``avg``: pad passages count in it, as in the reference) or max, or
    nothing (``none``). ``combine_hidden`` > 0 puts a linear layer of that
    width before the final ``combine``, with no activation between them.

    The JAX model takes each layer's kernel bank [B, K, L, P * L] at once;
    here each kernel's [B, L, P * L] values are summed as they are made, one
    layer at a time, so a forward never holds more than one layer's
    similarity matrix and one kernel's values (13 banks of a 100-document
    request would be 1.15 GB each in f32)."""

    def __init__(self, config: BertConfig, simmat_layers=(0, 6, 12), cls_mode="avg", maxqlen=20,
                 mus=(-0.9, -0.7, -0.5, -0.3, -0.1, 0.1, 0.3, 0.5, 0.7, 0.9), sigma=0.1, gradkernels=True,
                 combine_hidden=1024):
        super().__init__()
        if cls_mode not in ("avg", "max", "none"):
            raise ValueError(f"unknown CEDR cls mode {cls_mode!r}")
        self.config = config
        self.simmat_layers = tuple(int(x) for x in simmat_layers)
        self.cls_mode = cls_mode
        self.maxqlen = int(maxqlen)
        self.bert = BertEncoder(config)
        self._base_mus = torch.tensor(list(mus) + [1.0], dtype=torch.float32)
        self._base_sigmas = torch.tensor([float(sigma)] * len(mus) + [0.01], dtype=torch.float32)
        if gradkernels:
            self.mus = nn.Parameter(self._base_mus.clone())
            self.sigmas = nn.Parameter(self._base_sigmas.clone())
        else:  # constants, as in the JAX model: no parameter, nothing in the state dict
            self.register_buffer("mus", self._base_mus.clone(), persistent=False)
            self.register_buffer("sigmas", self._base_sigmas.clone(), persistent=False)
        width = len(self.simmat_layers) * len(self._base_mus) + (config.hidden_size if cls_mode != "none" else 0)
        if combine_hidden > 0:
            self.combine_hidden = nn.Linear(width, combine_hidden)
            width = combine_hidden
        self.combine = nn.Linear(width, 1)

    def flax_init_(self, generator: torch.Generator):
        """The kernel bank's initial mus and sigmas."""
        with torch.no_grad():
            self.mus.copy_(self._base_mus)
            self.sigmas.copy_(self._base_sigmas)

    def kernel_features(self, emb, qd_mask, b, p):
        """[B, K] pooled kernel features of one layer's hidden states [B * P, L, H]."""
        l = emb.shape[1]
        norm = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)
        sim = torch.where(qd_mask, torch.matmul(norm, norm.transpose(1, 2)), 0.0)
        sim = sim.reshape(b, p, l, l).transpose(1, 2).reshape(b, l, p * l)
        row_valid = (sim.abs().sum(dim=2) != 0.0)[:, None, :]
        k_sum = torch.stack([rbf_kernel_bank(sim, self.mus[k:k + 1], self.sigmas[k:k + 1])[:, 0].sum(dim=2)
                             for k in range(self.mus.shape[0])], dim=1)  # [B, K, L]
        return torch.where(row_valid, torch.log(k_sum.clamp_min(1e-10)) * 0.01, 0.0).sum(dim=2)

    def forward(self, inp, mask, seg, calibrate=False, dropout_seed=None):
        flat_inp, flat_mask, flat_seg, b, p = _flatten_passages(inp, mask, seg)
        _, pooled, all_hidden = self.bert(flat_inp, flat_mask, flat_seg, calibrate=calibrate,
                                          dropout_seed=dropout_seed, output_hidden_states=True)
        pos = torch.arange(flat_inp.shape[1], device=flat_inp.device)[None, :]
        valid = flat_mask > 0
        q_mask = (flat_seg == 0) & valid & (pos > 0) & (pos <= self.maxqlen)
        d_mask = (flat_seg == 1) & valid
        qd_mask = q_mask[:, :, None] & d_mask[:, None, :]
        features = [self.kernel_features(all_hidden[min(layer, len(all_hidden) - 1)].float(), qd_mask, b, p)
                    for layer in self.simmat_layers]
        del all_hidden
        if self.cls_mode != "none":
            cls = pooled.reshape(b, p, -1).float()
            features.append(cls.mean(dim=1) if self.cls_mode == "avg" else cls.amax(dim=1))
        combined = torch.cat(features, dim=1)
        if hasattr(self, "combine_hidden"):
            combined = self.combine_hidden(combined)
        return self.combine(combined)[:, :1]


@Reranker.register
class CEDRKNRM(_PooledReranker):
    """CEDR-KNRM: KNRM over contextualized embedding simmats plus CLS features
    (MacAvaney et al. 2019)."""

    module_name = "CEDRKNRM"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="pooledbertpassage"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("pretrained", "electra-base", "pretrained model (the reference's default)"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh (fast approximation) or erf (exact HF parity)"),
        ConfigOption("allowrandominit", False, "allow training from random weights when the pretrained checkpoint cannot be loaded"),
        ConfigOption("simmat_layers", "0..12,1", "encoder layers to build simmats from "
                     "(range syntax a..b,step or a comma list)", value_type="intlist"),
        ConfigOption("cls", "avg", "CLS feature pooling: avg, max, or none"),
        ConfigOption("mus", [-0.9, -0.7, -0.5, -0.3, -0.1, 0.1, 0.3, 0.5, 0.7, 0.9],
                     "RBF kernel centers (an exact-match kernel is appended)", value_type="floatlist"),
        ConfigOption("sigma", 0.1, "RBF kernel width"),
        ConfigOption("gradkernels", True, "tune mus and sigmas during training"),
        ConfigOption("combine_hidden", 1024, "hidden size of the combination FC layer (0 to disable)"),
        ConfigOption("hidden_dropout_prob", 0.1, "dropout probability of the encoder's hidden layers"),
        _QUANTIZE_OPT,
    ]

    def _make_model(self, config):
        return CedrKnrmModel(config, simmat_layers=tuple(self.config["simmat_layers"]),
                             cls_mode=self.config["cls"] or "none", maxqlen=self.extractor.config["maxqlen"],
                             mus=tuple(self.config["mus"]), sigma=float(self.config["sigma"]),
                             gradkernels=bool(self.config["gradkernels"]),
                             combine_hidden=int(self.config["combine_hidden"]))


@Reranker.register
class TFCEDRKNRMAlias(CEDRKNRM):
    module_name = "TFCEDRKNRM"


# ---------------------------------------------------------------- Birch
class BirchModel(nn.Module):
    """Birch's model: each passage scored by a linear ``relevance`` head over
    its pooled vector, the document's top-k passage scores (over all P
    passages, pad passages included, as in the reference) combined by
    ``topk_weights`` (k weights, initialised to 1/k) or, with ``hidden`` > 0,
    by ``combine_hidden``, a ReLU and ``combine_out``. Returns [B, 1]."""

    def __init__(self, config: BertConfig, topk: int = 3, hidden: int = 0, num_passages: int = 16):
        super().__init__()
        self.config = config
        self.topk = int(topk)
        self.k = min(self.topk, int(num_passages))
        self.bert = BertEncoder(config)
        self.relevance = nn.Linear(config.hidden_size, 1)
        if hidden > 0:
            self.combine_hidden = nn.Linear(self.k, hidden)
            self.combine_out = nn.Linear(hidden, 1)
        else:
            self.topk_weights = nn.Parameter(torch.full((self.k,), 1.0 / self.k))

    def flax_init_(self, generator: torch.Generator):
        if hasattr(self, "topk_weights"):
            with torch.no_grad():
                self.topk_weights.fill_(1.0 / self.k)

    def forward(self, inp, mask, seg, calibrate=False, dropout_seed=None):
        flat_inp, flat_mask, flat_seg, b, p = _flatten_passages(inp, mask, seg)
        _, pooled = self.bert(flat_inp, flat_mask, flat_seg, calibrate=calibrate, dropout_seed=dropout_seed)
        psg_scores = self.relevance(pooled.float())[:, 0].reshape(b, p)
        top = psg_scores.topk(min(self.topk, p), dim=1).values  # descending, as jax.lax.top_k
        if hasattr(self, "combine_out"):
            return self.combine_out(torch.relu(self.combine_hidden(top)))[:, :1]
        return (top * self.topk_weights).sum(dim=1, keepdim=True)


@Reranker.register
class Birch(_PooledReranker):
    """Birch: document ranking from sentence-level evidence (Yilmaz et al.
    2019): per-passage scores, the top k combined.

    With a pretrained checkpoint, the encoder loads its weights and the
    ``relevance`` head loads the checkpoint's NSP head (row 1 of
    ``cls.seq_relationship``, ``load_pretrained_nsp_head``). Unless
    ``finetune``, the encoder is frozen, and so is a loaded NSP head; a head
    that starts from random init trains."""

    module_name = "birch"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="birchbertpassage"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("pretrained", "msmarco_mb", "pretrained Birch model: mb, msmarco_mb, or car_mb "
                     "(the reference's default), or any BERT checkpoint name"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh (fast approximation) or erf (exact HF parity)"),
        ConfigOption("allowrandominit", False, "allow training from random weights when the pretrained checkpoint cannot be loaded"),
        ConfigOption("topk", 3, "number of top passages to combine"),
        ConfigOption("hidden", 0, "combiner hidden size, or 0 for a weighted sum of the topk"),
        ConfigOption("finetune", False, "fine-tune the BERT model (frozen otherwise)"),
        _QUANTIZE_OPT,
        _DROPOUT_OPT,
    ]

    def _make_model(self, config):
        return BirchModel(config, topk=self.config["topk"], hidden=int(self.config["hidden"]),
                          num_passages=self.extractor.config["numpassages"])

    def _load_pretrained(self, model):
        """The encoder's weights and, from the same checkpoint, the NSP head
        into ``relevance``, so that frozen-BERT training starts from the
        pretrained passage-relevance signal."""
        super()._load_pretrained(model)
        if getattr(self, "_pretrained_state", None) is None:
            return
        head = self._pretrained_nsp_head  # from encoder_config's read of the checkpoint
        if head is None:
            logger.warning("could not load the %s NSP head; the relevance layer starts from random init over %s "
                           "BERT features", self.config["pretrained"],
                           "trainable" if self.config["finetune"] else "frozen")
            return
        with torch.no_grad():
            model.relevance.weight.copy_(torch.from_numpy(head["kernel"].T))
            model.relevance.bias.copy_(torch.from_numpy(head["bias"]))
        self._nsp_head_loaded = True
        logger.info("loaded the pretrained NSP head into the relevance layer")

    def trainable(self, path, value):
        name = "/".join(map(str, path))
        if not self.config["finetune"]:
            if "bert" in name:
                return False
            # the reference freezes the whole NSP model, its head included; a
            # randomly initialised head must stay trainable
            if "relevance" in name and getattr(self, "_nsp_head_loaded", False):
                return False
        return True
