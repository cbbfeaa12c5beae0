"""SPLADE-style learned sparse expansion (SPLADE-max): the JAX package's
``reranker/splade.py``.

Every token's contextual embedding is projected onto the whole vocabulary by
BERT's masked-LM head (``MlmHead``: transform Dense + GELU + LayerNorm, then
the decoder) and max-pooled over the valid positions:

    rep(x)_v = max over valid positions i of  log(1 + relu(logit_iv))
    score(q, d) = rep(q) . rep(d)

The FLOPS regularizer (per side, the sum over the vocabulary of the squared
batch-mean activation) enters the training loss through the trainer's
``regularizer`` hook; inference never sees it. A pretrained checkpoint's MLM
head loads with the decoder tied to the word embeddings
(``load_pretrained_mlm_head``). Outside training, ``rep`` takes the max over
the positions a chunk of ``rep_chunk`` positions at a time, so that the
[B, L, V] logits never exist whole (128 x 256 x 30,522 f32 is 4.0 GB); the
max of chunk maxima is the same maximum. A trained checkpoint serves as
``searcher.name=impact searcher.encoder=splade``'s ``checkpointfile``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from capreolus_tpu_torch.core import ConfigOption
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder
from capreolus_tpu_torch.reranker.biencoder import BertRetrieverBase, _seed, encoder_inputs
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

REP_LOGIT_ELEMENTS = 1 << 26  # f32 logits [B, chunk, V] per chunk of an inference rep (256 MB)


class MlmHead(nn.Module):
    """BERT's masked-LM prediction head (HF ``cls.predictions``): transform
    Dense + GELU + LayerNorm, then the vocab decoder."""

    def __init__(self, hidden_size: int, vocab_size: int, gelu_approximate: bool = True,
                 layer_norm_eps: float = 1e-12):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.transform = nn.Linear(hidden_size, hidden_size)
        self.transform_ln = nn.LayerNorm(hidden_size, eps=layer_norm_eps)
        self.decoder = nn.Linear(hidden_size, vocab_size)

    def forward(self, x):
        x = F.gelu(self.transform(x), approximate="tanh" if self.gelu_approximate else "none")
        return self.decoder(self.transform_ln(x))


class SpladeModel(nn.Module):
    """Shared-encoder vocab-expansion representations + dot-product scoring."""

    def __init__(self, config: BertConfig, vocab_size: int, cls_id: int = 101, sep_id: int = 102):
        super().__init__()
        self.config = config
        self.vocab_size = vocab_size
        self.cls_id, self.sep_id = cls_id, sep_id
        self.bert = BertEncoder(config)
        self.mlm = MlmHead(config.hidden_size, vocab_size, gelu_approximate=config.gelu_approximate,
                           layer_norm_eps=config.layer_norm_eps)

    def rep(self, toks, dropout_seed=None):
        """[B, L] ids -> [B, V] sparse representations (>= 0)."""
        toks, mask = encoder_inputs(toks, self.config.max_position)
        hidden, _ = self.bert(toks, mask, torch.zeros_like(toks), dropout_seed=dropout_seed)
        hidden = hidden.float()
        valid = (toks != 0) & (toks != self.cls_id) & (toks != self.sep_id)
        if torch.is_grad_enabled():
            w = torch.log1p(torch.relu(self.mlm(hidden)))  # [B, L, V]
            return torch.where(valid[..., None], w, 0.0).amax(dim=1)
        b, length = toks.shape
        step = max(1, REP_LOGIT_ELEMENTS // max(1, b * self.vocab_size))
        out = None
        for l0 in range(0, length, step):
            w = torch.log1p(torch.relu(self.mlm(hidden[:, l0 : l0 + step])))
            part = torch.where(valid[:, l0 : l0 + step, None], w, 0.0).amax(dim=1)
            out = part if out is None else torch.maximum(out, part)
        return out

    def forward(self, querytoks, doctoks, query_idf=None, dropout_seed=None):
        q = self.rep(querytoks, _seed(dropout_seed, 0))
        d = self.rep(doctoks, _seed(dropout_seed, 1))
        return (q * d).sum(dim=-1)

    def flops(self, querytoks, doctoks, dropout_seed=None):
        """FLOPS regularizer: for each side, sum_v (batch mean of rep_v)^2."""
        def f(toks, i):
            return (self.rep(toks, _seed(dropout_seed, i)).mean(dim=0) ** 2).sum()

        return f(querytoks, 2) + f(doctoks, 3)


def load_pretrained_mlm_head(name: str, config: BertConfig):
    """BERT's masked-LM head of checkpoint ``name`` (a local directory or a
    hub-cache snapshot, read without ``transformers``) as an ``MlmHead``
    state_dict: the transform and its LayerNorm, and the decoder TIED to the
    word embeddings (``bert.embeddings.word_embeddings.weight``) with the
    per-vocab bias ``cls.predictions.bias``. None when nothing can be read."""
    from capreolus_tpu_torch.reranker.bert import checkpoint
    from capreolus_tpu_torch.reranker.bert.encoder import PRETRAINED_ALIASES, _f32_tensor

    name = PRETRAINED_ALIASES.get(name, name)
    try:
        sd = checkpoint.read_state_dict(checkpoint.find_checkpoint(name))
    except Exception:
        return None  # nothing local: train the head from init
    try:
        return {
            "transform.weight": _f32_tensor(sd["cls.predictions.transform.dense.weight"]),
            "transform.bias": _f32_tensor(sd["cls.predictions.transform.dense.bias"]),
            "transform_ln.weight": _f32_tensor(sd["cls.predictions.transform.LayerNorm.weight"]),
            "transform_ln.bias": _f32_tensor(sd["cls.predictions.transform.LayerNorm.bias"]),
            "decoder.weight": _f32_tensor(sd["bert.embeddings.word_embeddings.weight"]),  # tied: [V, H]
            "decoder.bias": _f32_tensor(sd["cls.predictions.bias"]),
        }
    except KeyError as e:
        # the checkpoint read but has no MLM head under these names: training from a
        # random head while claiming the pretrained start must be loud
        logger.warning("pretrained MLM head of %s could not be mapped (%s); the SPLADE head will "
                       "train from random init", name, e)
        return None


@Reranker.register
class Splade(BertRetrieverBase):
    """Learned sparse expansion retriever; export via searcher.name=impact
    searcher.encoder=splade."""

    module_name = "splade"
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "encoder checkpoint (or 'tiny' offline)"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh or erf"),
        ConfigOption("allowrandominit", False, "allow random init when the checkpoint cannot be loaded"),
        ConfigOption("hidden_dropout_prob", 0.1, "encoder dropout during training"),
        ConfigOption("regweight", 1e-3, "FLOPS sparsity regularizer weight (0 disables; "
                     "applied to both query and doc representations during training)"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            tok = self.extractor.tokenizer
            self.model = SpladeModel(self.encoder_config(), vocab_size=int(tok.vocab_size),
                                     cls_id=int(tok.cls_id), sep_id=int(tok.sep_id))
            self._load_pretrained(self.model)
        return self.model

    def _load_pretrained(self, model):
        super()._load_pretrained(model)
        if self._pretrained_state is None:
            return
        mlm = load_pretrained_mlm_head(self.config["pretrained"], model.config)
        if mlm is not None and mlm["decoder.weight"].shape[0] == int(model.vocab_size):
            model.mlm.load_state_dict(mlm)
            logger.info("loaded the pretrained MLM head (decoder tied to embeddings)")

    def regularizer(self, batch, device, dropout_seed=None):
        """Trainer hook: ``regweight`` times the FLOPS penalty over the query
        and positive-doc reps (the negative doc shares the doc distribution)."""
        lam = float(self.config["regweight"])
        if lam <= 0.0:
            return torch.zeros((), device=device)
        return lam * self.model.flops(self.put(batch, "query", device), self.put(batch, "posdoc", device),
                                      dropout_seed=dropout_seed)
