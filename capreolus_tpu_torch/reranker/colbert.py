"""ColBERT late-interaction model (Khattab & Zaharia, SIGIR'20): the JAX
package's ``reranker/colbert.py``.

Every query and document token is projected to a compact per-token
embedding, and the relevance score is MaxSim: the sum over query tokens of the
max dot product against the document's tokens. [Q]/[D] marker tokens are
inserted after [CLS] (BERT's [unused0]/[unused1] ids); query [PAD]s become
[MASK] and the query encoder attends over every position (query augmentation);
the projections are L2-normalised and carry no bias.

The trainable ``ColBERT`` reranker (``reranker.name=colbert``) trains with the
port's trainer over the ``berttext`` extractor (``specialtokens=True``, the
``[CLS] ... [SEP]`` layout the searcher serves). A training forward takes a
dropout seed: the encoder drops at the config's rates and attends through
``attention_plain``, and MaxSim is this module's differentiable ``maxsim``,
never K3 (which has no backward). A prediction runs the encoder through K2 on
the card. Its ``dev.best`` (``params/bert/...``, ``params/linear/kernel``) is
the ``colbert`` searcher's ``checkpointfile``, in either package.
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

# bert-base-uncased WordPiece ids: [unused0]=1 marks queries, [unused1]=2
# marks documents, [MASK]=103 augments
QUERY_MARKER = 1
DOC_MARKER = 2
MASK_ID = 103


def insert_marker(toks, marker_id):
    """[CLS] t1 t2 ... -> [CLS] [marker] t1 t2 ... (length preserved: the last
    token drops, mirroring ColBERT's tokenizer-side marker insertion)."""
    toks = torch.as_tensor(toks)
    marker = torch.full_like(toks[:, :1], marker_id)
    return torch.cat([toks[:, :1], marker, toks[:, 1:-1]], dim=1)


class ColBERTModel(nn.Module):
    """score(q, d) = sum_i max_j  E_q(q)_i . E_d(d)_j   (both L2-normalised).

    ``bert`` and ``linear`` carry the flax submodules' names, so a flattened
    JAX checkpoint maps onto the state_dict by name."""

    def __init__(self, config: BertConfig, dim: int = 128, query_augment: bool = True):
        super().__init__()
        self.config = config
        self.dim = dim
        self.query_augment = query_augment
        self.bert = BertEncoder(config)
        self.linear = nn.Linear(config.hidden_size, dim, bias=False)

    def encode_query(self, toks, dropout_seed=None):
        """[B, Lq] ids -> ([B, Lq, dim] f32 embeddings, None); a
        ``dropout_seed`` makes it a training forward."""
        toks = insert_marker(toks, QUERY_MARKER)
        if self.query_augment:
            toks = torch.where(toks == 0, MASK_ID, toks)
        # augmentation: attend over every position (MASK slots included)
        return self._project(toks, torch.ones_like(toks), dropout_seed), None

    def encode_doc(self, toks, dropout_seed=None):
        """[B, Ld] ids -> ([B, Ld, dim] f32 embeddings, [B, Ld] int32 mask)."""
        toks = insert_marker(toks, DOC_MARKER)
        mask = (toks != 0).to(torch.int32)
        return self._project(toks, mask, dropout_seed), mask

    def _project(self, toks, mask, dropout_seed):
        # the JAX encoder's token types default to zeros
        hidden, _ = self.bert(toks, mask, torch.zeros_like(toks), dropout_seed=dropout_seed)
        emb = self.linear(hidden).float()
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)

    def forward(self, querytoks, doctoks, query_idf=None, dropout_seed=None):
        """[B] MaxSim scores; the query and the doc encoders draw their
        dropout from seeds of their own."""
        def seed(i):
            return None if dropout_seed is None else dropout_generator_seed(dropout_seed, i)

        q, _ = self.encode_query(querytoks, seed(0))   # [B, Lq, dim]
        d, dmask = self.encode_doc(doctoks, seed(1))   # [B, Ld, dim]
        return maxsim(q, d, dmask)


def maxsim(q, d, dmask):
    """[B, Lq, dim] x [B, Ld, dim] -> [B] MaxSim scores (one batched matmul
    and a masked max/sum). dmask [B, Ld] zeroes padded doc tokens."""
    sim = torch.einsum("bqe,bke->bqk", q, d)                  # [B, Lq, Ld]
    sim = torch.where(dmask[:, None, :] > 0, sim, -1e9)
    return sim.amax(dim=-1).sum(dim=-1)


@Reranker.register
class ColBERT(Reranker):
    """Trainable late-interaction reranker; its checkpoint serves as
    ``searcher.name=colbert``'s ``checkpointfile``."""

    module_name = "colbert"
    dependencies = [
        # the [CLS] ... [SEP] layout the late-interaction searcher serves
        Dependency(key="extractor", module="extractor", name="berttext",
                   default_config_overrides={"specialtokens": True}),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("pretrained", "bert-base-uncased", "encoder checkpoint (or 'tiny' offline)"),
        ConfigOption("dim", 128, "per-token embedding dimension"),
        ConfigOption("queryaugment", True, "expand query [PAD]s to [MASK] (ColBERT query augmentation)"),
        ConfigOption("gelu", "tanh", "GELU variant: tanh or erf"),
        ConfigOption("allowrandominit", False, "allow random init when the checkpoint cannot be loaded"),
        ConfigOption("hidden_dropout_prob", 0.1, "encoder dropout during training"),
    ]

    accepts_rngs = True  # encoder dropout during training

    def build(self):
        if self.config["gelu"] not in ("tanh", "erf"):
            raise ConfigError(f"colbert gelu must be 'tanh' or 'erf', got {self.config['gelu']!r}")
        if int(self.config["dim"]) <= 0:
            raise ConfigError("colbert dim must be positive")

    def build_model(self):
        if not hasattr(self, "model"):
            cfg, self._pretrained_state = load_pretrained_encoder(
                self.config["pretrained"], allow_random_init=bool(self.config["allowrandominit"]))
            rate = float(self.config["hidden_dropout_prob"])
            cfg = dataclasses.replace(cfg, gelu_approximate=self.config["gelu"] == "tanh",
                                      hidden_dropout_prob=rate, attention_dropout_prob=rate)
            self.model = ColBERTModel(cfg, dim=int(self.config["dim"]),
                                      query_augment=bool(self.config["queryaugment"]))
            self._load_pretrained(self.model)
        return self.model

    def _load_pretrained(self, model):
        if self._pretrained_state is not None:
            model.bert.load_state_dict(self._pretrained_state)
            logger.info("loaded pretrained weights into the ColBERT encoder")

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
