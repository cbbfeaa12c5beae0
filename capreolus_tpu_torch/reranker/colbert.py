"""ColBERT late-interaction model (Khattab & Zaharia, SIGIR'20): the JAX
package's ``reranker/colbert.py`` as far as the late-interaction searcher
needs it.

Every query and document token is projected to a compact per-token
embedding, and the relevance score is MaxSim: the sum over query tokens of the
max dot product against the document's tokens. [Q]/[D] marker tokens are
inserted after [CLS] (BERT's [unused0]/[unused1] ids); query [PAD]s become
[MASK] and the query encoder attends over every position (query augmentation);
the projections are L2-normalised and carry no bias.

The trainable ``ColBERT`` reranker waits for the trainer slice (it needs the
``berttext`` extractor and the trainer); its checkpoints, flattened to
``params/bert/...`` and ``params/linear/kernel``, load through
``convert.bert_state_dict``.
"""

from __future__ import annotations

import torch
from torch import nn

from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder

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

    def encode_query(self, toks):
        """[B, Lq] ids -> ([B, Lq, dim] f32 embeddings, None)."""
        toks = insert_marker(toks, QUERY_MARKER)
        if self.query_augment:
            toks = torch.where(toks == 0, MASK_ID, toks)
        # augmentation: attend over every position (MASK slots included)
        return self._project(toks, torch.ones_like(toks)), None

    def encode_doc(self, toks):
        """[B, Ld] ids -> ([B, Ld, dim] f32 embeddings, [B, Ld] int32 mask)."""
        toks = insert_marker(toks, DOC_MARKER)
        mask = (toks != 0).to(torch.int32)
        return self._project(toks, mask), mask

    def _project(self, toks, mask):
        # the JAX encoder's token types default to zeros
        hidden, _ = self.bert(toks, mask, torch.zeros_like(toks))
        emb = self.linear(hidden).float()
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)

    def forward(self, querytoks, doctoks):
        q, _ = self.encode_query(querytoks)   # [B, Lq, dim]
        d, dmask = self.encode_doc(doctoks)   # [B, Ld, dim]
        return maxsim(q, d, dmask)


def maxsim(q, d, dmask):
    """[B, Lq, dim] x [B, Ld, dim] -> [B] MaxSim scores (one batched matmul
    and a masked max/sum). dmask [B, Ld] zeroes padded doc tokens."""
    sim = torch.einsum("bqe,bke->bqk", q, d)                  # [B, Lq, Ld]
    sim = torch.where(dmask[:, None, :] > 0, sim, -1e9)
    return sim.amax(dim=-1).sum(dim=-1)
