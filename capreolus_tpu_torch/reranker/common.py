"""Shared model layers (the similarity-matrix and kernel-pooling functions of
the JAX package's ``reranker/common.py``), as plain functions on tensors, and
the training losses (``LOSS_FUNCTIONS``, all six of its keys).

These are the model's differentiable path. The fused inference kernel
(``ops/simmat.py``) normalises differently (``norm + 1e-9``); each is held
against its own JAX counterpart.

``cudnn_f32`` keeps cuDNN's convolutions and recurrences in IEEE f32 (the JAX
package's f32; PyTorch's ``torch.backends.cudnn.allow_tf32`` defaults to
True), ``matmul_f32`` does the same for cuBLAS's f32 matmuls, and
``conv_same`` pads a convolution's input as XLA's ``SAME`` does.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

# KNRM / CEDR kernel bank defaults (Xiong et al. SIGIR'17)
KNRM_MUS = (-0.9, -0.7, -0.5, -0.3, -0.1, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0)
KNRM_SIGMAS = (0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.001)

PAD = 0


class _F32Scope:
    """A process-wide TF32 flag held off while any caller is inside: the
    callers are counted under a lock, the first to enter clears the flag and
    the last to leave restores what the first found, so that overlapping
    threads (a threaded server's requests) or nested calls never restore it
    while another caller is still inside. Usable as a context manager and as a
    decorator (``@scope()``)."""

    def __init__(self, module, attr):
        self._module, self._attr = module, attr
        self._lock = threading.Lock()
        self._holders = [0, None]  # [callers inside, the flag the first of them found]

    @contextlib.contextmanager
    def __call__(self):
        with self._lock:
            if self._holders[0] == 0:
                self._holders[1] = getattr(self._module, self._attr)
                setattr(self._module, self._attr, False)
            self._holders[0] += 1
        try:
            yield
        finally:
            with self._lock:
                self._holders[0] -= 1
                if self._holders[0] == 0:
                    setattr(self._module, self._attr, self._holders[1])


# cuDNN convolutions and recurrences without TF32 for the duration: the zoo's
# convolutions and GRU / LSTM layers compute in f32 whatever the caller's
# ``torch.backends.cudnn.allow_tf32`` (PyTorch's default is True)
cudnn_f32 = _F32Scope(torch.backends.cudnn, "allow_tf32")
# cuBLAS f32 matmuls without TF32 for the duration: every f32 path on the card
# (the BERT encoders of the services and searchers, the rerank stage, the
# trainer's steps and predictions) computes in IEEE f32 whatever the process
# set. ``torch.set_float32_matmul_precision("high")`` or ``("medium")`` and
# ``torch.backends.cuda.matmul.fp32_precision = "tf32"`` all set this flag,
# and clearing it sets ``fp32_precision`` to "ieee"
matmul_f32 = _F32Scope(torch.backends.cuda.matmul, "allow_tf32")


def same_padding(kernel_size: int):
    """XLA's ``SAME`` padding of one axis at stride 1: (k - 1) // 2 before,
    the rest after (0 and 1 for a kernel of 2)."""
    return (kernel_size - 1) // 2, kernel_size - 1 - (kernel_size - 1) // 2


def conv_same(conv, x):
    """``conv`` (an ``nn.Conv1d`` or ``nn.Conv2d``) over channels-first ``x``
    padded with zeros as flax's ``nn.Conv(padding="SAME")`` pads it."""
    pads = []
    for k in reversed(conv.kernel_size):  # F.pad takes the last axis first
        pads.extend(same_padding(k))
    return conv(F.pad(x, pads))


def cosine_rows(x, eps=1e-9):
    """``x / (‖x‖ + eps)`` over the last axis (the zoo models' ``norm``)."""
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def _mask_padding(sim, query_tok, doc_tok):
    sim = torch.where(query_tok[:, :, None] == PAD, 0.0, sim)
    return torch.where(doc_tok[:, None, :] == PAD, 0.0, sim)


def exact_match_matrix(query_tok, doc_tok):
    """1.0 where non-padding tokens match exactly, else 0 ([B, Q, D])."""
    sim = (query_tok[:, :, None] == doc_tok[:, None, :]).to(torch.float32)
    return _mask_padding(sim, query_tok, doc_tok)


def cosine_similarity_matrix(q_emb, d_emb, query_tok, doc_tok, eps=1e-9):
    """Cosine similarity [B, Q, D] with padding masked to 0, in f32.

    The norm is clamped BELOW the sqrt (``sqrt(max(sum_sq, eps^2))``) rather than
    added after it, so the gradient stays finite at the all-zero padding row
    (torch ``cosine_similarity``'s clamp_min semantics). The norms are in the
    embeddings' dtype (bf16 under ``trainer.amp``) and the dot products in f32,
    as the JAX function's ``preferred_element_type`` takes them.
    """
    q_norm = torch.sqrt(torch.clamp_min(torch.sum(q_emb * q_emb, dim=2, keepdim=True), eps * eps))
    d_norm = torch.sqrt(torch.clamp_min(torch.sum(d_emb * d_emb, dim=2, keepdim=True), eps * eps))
    sim = torch.bmm(q_emb.float(), d_emb.float().transpose(1, 2))
    sim = sim / q_norm / d_norm.transpose(1, 2)
    return _mask_padding(sim, query_tok, doc_tok)


def stacked_similarity_matrix(query_embeds, doc_embeds, query_tok, doc_tok):
    """Per-layer cosine simmats stacked on axis 1 -> [B, L, Q, D]."""
    sims = [cosine_similarity_matrix(q_emb, d_emb, query_tok, doc_tok)
            for q_emb, d_emb in zip(query_embeds, doc_embeds)]
    return torch.stack(sims, dim=1)


def similarity_matrix(embedding_matrix, query_tok, doc_tok):
    """Cosine channel on in-vocab ids + exact-match channel on negative OOV ids
    (padding is 0, OOV terms carry negative ids; the two channels are summed)."""
    exact = exact_match_matrix(torch.clamp_max(query_tok, 0), torch.clamp_max(doc_tok, 0))
    q_ids = torch.clamp_min(query_tok, 0)
    d_ids = torch.clamp_min(doc_tok, 0)
    q_emb = embedding_matrix[q_ids]
    d_emb = embedding_matrix[d_ids]
    cos = cosine_similarity_matrix(q_emb, d_emb, q_ids, d_ids)
    return exact + cos


def rbf_kernel_bank(simmat, mus, sigmas):
    """exp(-0.5 (x - mu)^2 / sigma^2) for each kernel -> [B, K, ...]."""
    x = simmat[:, None]  # [B, 1, ...]
    shape = (1, -1) + (1,) * (simmat.dim() - 1)
    mus = torch.as_tensor(mus, dtype=simmat.dtype, device=simmat.device).reshape(shape)
    sigmas = torch.as_tensor(sigmas, dtype=simmat.dtype, device=simmat.device).reshape(shape)
    adj = x - mus
    return torch.exp(-0.5 * adj * adj / (sigmas * sigmas))


def knrm_pool(simmat, mus, sigmas):
    """KNRM soft-TF pooling: kernels -> sum over doc -> log -> sum over query.

    Returns [B, K]. Query positions whose simmat row is entirely zero (padding)
    are excluded.
    """
    kernels = rbf_kernel_bank(simmat, mus, sigmas)  # [B, K, Q, D]
    result = kernels.sum(dim=3)  # [B, K, Q]
    mask = (simmat.sum(dim=2) != 0.0)[:, None, :]  # [B, 1, Q]
    return torch.where(mask, torch.log(result + 1e-6), 0.0).sum(dim=2)  # [B, K]


# ------------------------------------------------------------------ losses
def pair_hinge_loss(pos_neg_scores, *args):
    """Margin-1 pairwise hinge."""
    pos, neg = pos_neg_scores
    return torch.mean(torch.relu(1.0 - (pos - neg)))


def pair_softmax_loss(pos_neg_scores, *args):
    """1 - P(pos) under a 2-way softmax."""
    scores = torch.stack(list(pos_neg_scores), dim=1)
    return torch.mean(1.0 - torch.softmax(scores, dim=1)[:, 0])


def crossentropy_loss(scores_2way, labels_2way):
    """Categorical CE over [B, 2] scores against one-hot labels."""
    logprobs = torch.log_softmax(scores_2way, dim=-1)
    return -torch.mean(torch.sum(labels_2way * logprobs, dim=-1))


def lce_loss(group_scores, labels=None):
    """Localized contrastive estimation: CE with the positive at index 0 ([B, 1+nneg])."""
    return -torch.mean(torch.log_softmax(group_scores, dim=-1)[:, 0])


def infonce_loss(logits, labels):
    """In-batch-negative contrastive loss: categorical CE of each row of the
    [B, C] similarity matrix against its positive's column ``labels[i]``."""
    logprobs = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logprobs, 1, labels[:, None].long()))


def margin_mse_loss(pos, neg, teacher_margin):
    """Margin-MSE distillation: the student's pos - neg margin against the teacher's."""
    return torch.mean(((pos - neg) - teacher_margin) ** 2)


LOSS_FUNCTIONS = {
    "pairwise_hinge_loss": pair_hinge_loss,
    "pair_hinge_loss": pair_hinge_loss,
    "pair_softmax_loss": pair_softmax_loss,
    "crossentropy": crossentropy_loss,
    "lce": lce_loss,
    # margin_mse takes the batch's per-triple teacher margin (sampler.name=distill)
    "margin_mse": margin_mse_loss,
    # infonce takes the in-batch similarity matrix of a reranker with encode() (the biencoder)
    "infonce": infonce_loss,
}
