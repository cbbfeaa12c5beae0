"""Sequence and context interaction rankers (the JAX package's
``reranker/sequence_models.py``): DUET, POSITDRMM, HINT, TK and DeepTileBar.

Recurrences carry flax's cells' parameters by name: a ``GRUCell`` is the
Dense layers ``ir``, ``iz``, ``in`` (with biases), ``hr``, ``hz`` (without)
and ``hn`` (with), an ``OptimizedLSTMCell`` ``ii``..``io`` (without) and
``hi``..``ho`` (with). They run as one ``torch.gru`` / ``torch.lstm`` call
(cuDNN on the card) whose weights are the cell's, stacked in torch's gate
order; flax's GRU is torch's with the hidden-state biases of r and z at 0.
Like flax's ``nn.RNN`` without ``seq_lengths``, they run over pad positions
too. A bidirectional pair is flax's ``reverse=True, keep_order=True``: the
backward outputs stay at their input positions.

HINT's 2-D spatial GRU runs as a loop over the Q + W - 1 anti-diagonals of a
window, each diagonal's cells at once, as the JAX ``lax.scan`` does. TK's
attention is flax's ``MultiHeadDotProductAttention`` as plain operations (the
JAX model runs it in XLA, not through its flash-attention kernel). Forwards
that reach cuDNN run under ``cudnn_f32``. Dropout sites (DUET's
``dropoutrate``, POSITDRMM's 0.2 on its inputs, TK's 0.1 on the positional
branch) draw from the port's generators.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert.encoder import dropout
from capreolus_tpu_torch.reranker.common import (KNRM_MUS, KNRM_SIGMAS, conv_same, cosine_rows, cudnn_f32,
                                                 exact_match_matrix, knrm_pool, similarity_matrix)
from capreolus_tpu_torch.reranker.interaction import ZooReranker, _embedding, _lookup


class RecurrentDense(nn.Linear):
    """A cell's hidden-state Dense layer: flax draws its kernel orthogonal and its bias 0."""

    def flax_init_(self, generator: torch.Generator):
        from capreolus_tpu_torch.convert import orthogonal_

        orthogonal_(self.weight, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()


class GRUCell(nn.Module):
    """flax ``nn.GRUCell``'s parameters."""

    def __init__(self, in_features, features):
        super().__init__()
        self.features = features
        for gate in ("r", "z", "n"):
            self.add_module(f"i{gate}", nn.Linear(in_features, features))
            self.add_module(f"h{gate}", RecurrentDense(features, features, bias=gate == "n"))

    def torch_weights(self):
        """[w_ih, w_hh, b_ih, b_hh] in torch's gate order r, z, n."""
        gates = [getattr(self, f"i{g}") for g in "rzn"]
        hidden = [getattr(self, f"h{g}") for g in "rzn"]
        b_hh = torch.cat([self.hn.bias.new_zeros(2 * self.features), self.hn.bias])
        return [torch.cat([g.weight for g in gates]), torch.cat([h.weight for h in hidden]),
                torch.cat([g.bias for g in gates]), b_hh]


class OptimizedLSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell``'s parameters (gates i, f, g, o)."""

    def __init__(self, in_features, features):
        super().__init__()
        self.features = features
        for gate in "ifgo":
            self.add_module(f"i{gate}", nn.Linear(in_features, features, bias=False))
            self.add_module(f"h{gate}", RecurrentDense(features, features))

    def torch_weights(self):
        """[w_ih, w_hh, b_ih, b_hh] in torch's gate order i, f, g, o (flax's biases are the hidden layers')."""
        hidden = [getattr(self, f"h{g}") for g in "ifgo"]
        b_hh = torch.cat([h.bias for h in hidden])
        return [torch.cat([getattr(self, f"i{g}").weight for g in "ifgo"]), torch.cat([h.weight for h in hidden]),
                torch.zeros_like(b_hh), b_hh]


def run_rnn(cells, x):
    """flax ``nn.RNN(cell)`` over x [B, L, in] from a zero carry -> [B, L, H];
    with two cells, the second runs backward with ``keep_order``, and the two
    outputs are concatenated -> [B, L, 2H]."""
    cell = cells[0]
    params = [w for c in cells for w in c.torch_weights()]
    h0 = x.new_zeros(len(cells), x.shape[0], cell.features)
    args = (params, True, 1, 0.0, torch.is_grad_enabled(), len(cells) == 2, True)
    if isinstance(cell, GRUCell):
        return torch.gru(x.contiguous(), h0, *args)[0]
    return torch.lstm(x.contiguous(), (h0, h0), *args)[0]


class _BiGRU(nn.Module):
    """A forward and a backward GRU (``GRUCell_0``, ``GRUCell_1``), concatenated."""

    def __init__(self, in_features, features):
        super().__init__()
        self.GRUCell_0 = GRUCell(in_features, features)
        self.GRUCell_1 = GRUCell(in_features, features)

    def forward(self, x):
        return run_rnn((self.GRUCell_0, self.GRUCell_1), x)


# ------------------------------------------------------------------------- DUET
class DUETModel(nn.Module):
    """The local model's ``local_conv`` is flax's ``Conv(kernel_size=(1,))``
    over the [B, Q, D] exact-match matrix: the D doc positions are its input
    channels and Q its length (a Dense from the doc positions, per query term)."""

    def __init__(self, embedding, maxqlen, maxdoclen, nfilters=10, lmhidden=30, nhidden=699, idfweight=True,
                 activation="relu", dropoutrate=0.5):
        super().__init__()
        self.idfweight, self.dropoutrate = idfweight, dropoutrate
        self.act = torch.relu if activation == "relu" else torch.tanh
        self.embedding = _embedding(embedding)
        dim = self.embedding.shape[1]
        self.local_conv = nn.Conv1d(maxdoclen, nfilters, 1)
        self.local_ffw1 = nn.Linear(maxqlen * nfilters, lmhidden)
        self.local_out = nn.Linear(lmhidden, 1)
        self.dist_conv_q = nn.Conv1d(dim, nfilters, 3)
        self.dist_conv_d = nn.Conv1d(dim, nfilters, 3)
        self.dist_ffw1 = nn.Linear(3 * nfilters, nhidden)
        self.dist_out = nn.Linear(nhidden, 1)

    def _pooled(self, conv, toks):
        h = self.act(conv_same(conv, _lookup(self.embedding, toks).transpose(1, 2))).transpose(1, 2)
        return torch.where((toks != 0)[..., None], h, -1e7).amax(dim=1)

    @cudnn_f32()
    def forward(self, querytoks, doctoks, query_idf, dropout_seed=None):
        exact = exact_match_matrix(querytoks, doctoks)  # [B, Q, D]
        if self.idfweight:
            exact = exact * query_idf[:, :, None]
        h = self.act(self.local_conv(exact.transpose(1, 2))).transpose(1, 2)  # [B, Q, nfilters]
        local = dropout(self.act(self.local_ffw1(h.reshape(h.shape[0], -1))), self.dropoutrate, dropout_seed, 0)
        local_score = self.local_out(local)[:, 0]

        q_vec, d_vec = self._pooled(self.dist_conv_q, querytoks), self._pooled(self.dist_conv_d, doctoks)
        inter = torch.cat([q_vec * d_vec, q_vec, d_vec], dim=-1)
        dist = dropout(self.act(self.dist_ffw1(inter)), self.dropoutrate, dropout_seed, 1)
        return local_score + self.dist_out(dist)[:, 0]


@Reranker.register
class DUET(ZooReranker):
    """Bhaskar Mitra, Fernando Diaz, Nick Craswell. 2017. Learning to Match using Local
    and Distributed Representations of Text for Web Search."""

    module_name = "DUET"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="slowembedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("nfilters", 10, "filters for local and distributed models"),
        ConfigOption("lmhidden", 30, "local model hidden size"),
        ConfigOption("nhidden", 699, "distributed model hidden size"),
        ConfigOption("idfweight", True, "weight local matches by query idf"),
        ConfigOption("dropoutrate", 0.5, "dropout probability"),
        ConfigOption("activation", "relu", "tanh or relu"),
    ]
    accepts_rngs = True  # DUET trains with dropout

    def build_model(self):
        if not hasattr(self, "model"):
            c, e = self.config, self.extractor.config
            self.model = DUETModel(self.extractor.embeddings, e["maxqlen"], e["maxdoclen"], nfilters=c["nfilters"],
                                   lmhidden=c["lmhidden"], nhidden=c["nhidden"], idfweight=c["idfweight"],
                                   activation=c["activation"], dropoutrate=c["dropoutrate"])
        return self.model


# ------------------------------------------------------------------------- POSITDRMM
class POSITDRMMModel(nn.Module):
    def __init__(self, embedding, hidden=32, topk=5):
        super().__init__()
        self.topk = topk
        self.embedding = _embedding(embedding)
        dim = self.embedding.shape[1]
        self.context_gru = _BiGRU(dim, hidden)
        self.context_proj = nn.Linear(2 * hidden, dim)
        self.term_mlp = nn.Linear(topk + 1, 1)
        self.gate = nn.Linear(1, 1, bias=False)

    @cudnn_f32()
    def forward(self, querytoks, doctoks, query_idf, dropout_seed=None):
        # dropout 0.2 on the encoder's inputs during training
        q_emb = dropout(_lookup(self.embedding, querytoks), 0.2, dropout_seed, 0)
        d_emb = dropout(_lookup(self.embedding, doctoks), 0.2, dropout_seed, 1)
        q_ctx = q_emb + self.context_proj(self.context_gru(q_emb))  # a shared BiGRU, residual
        d_ctx = d_emb + self.context_proj(self.context_gru(d_emb))
        q_mask, d_mask = querytoks != 0, doctoks != 0
        sim = torch.bmm(cosine_rows(q_ctx), cosine_rows(d_ctx).transpose(1, 2))
        sim = torch.where(q_mask[:, :, None] & d_mask[:, None, :], sim, -1e7)
        topk_vals = torch.topk(sim, min(self.topk, sim.shape[-1]), dim=-1).values  # [B, Q, k]
        exact = exact_match_matrix(querytoks, doctoks)
        exact_stats = exact.sum(dim=2, keepdim=True) / torch.clamp_min(d_mask.sum(dim=1), 1)[:, None, None]
        term_scores = torch.tanh(self.term_mlp(torch.cat([topk_vals, exact_stats], dim=-1)))[..., 0]
        gate = torch.softmax(torch.where(q_mask, self.gate(query_idf[..., None])[..., 0], -1e7), dim=1)
        return (gate * term_scores).sum(dim=1)


@Reranker.register
class POSITDRMM(ZooReranker):
    """Ryan McDonald, George Brokos, Ion Androutsopoulos. 2018. Deep Relevance Ranking
    using Enhanced Document-Query Interactions."""

    module_name = "POSITDRMM"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="slowembedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [ConfigOption("hidden", 32, "BiGRU hidden size"), ConfigOption("topk", 5, "top-k matches per term")]
    accepts_rngs = True  # trains with input dropout

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = POSITDRMMModel(self.extractor.embeddings, hidden=self.config["hidden"],
                                        topk=self.config["topk"])
        return self.model


# ------------------------------------------------------------------------- HINT
class SpatialGRU2D(nn.Module):
    """The 2-D spatial GRU of the JAX ``SpatialGRU2D``: each cell's hidden state
    depends on its left, top and diagonal neighbours through 3 sigmoid reset
    gates and 4 softmax-normalised update gates. It runs as a loop over the
    Q + W - 1 anti-diagonals, every cell of a diagonal at once, and returns the
    bottom-right cell's state. Its parameters are the JAX module's raw leaves,
    in flax's [in, out] layout, drawn uniform in ±1/√hidden."""

    def __init__(self, channels, hidden):
        super().__init__()
        self.hidden = hidden
        h = hidden
        self.Wrz_kernel = nn.Parameter(torch.zeros(3 * h + channels, 7 * h))
        self.Wrz_bias = nn.Parameter(torch.zeros(7 * h))
        self.W_kernel = nn.Parameter(torch.zeros(channels, h))
        self.W_bias = nn.Parameter(torch.zeros(h))
        self.U_kernel = nn.Parameter(torch.zeros(3 * h, h))
        self.U_bias = nn.Parameter(torch.zeros(h))

    def flax_init_(self, generator: torch.Generator):
        std = 1.0 / np.sqrt(self.hidden)
        with torch.no_grad():
            for p in self.parameters(recurse=False):
                p.uniform_(-std, std, generator=generator)

    def cell(self, x, hdiag, htop, hleft):
        rz = torch.cat([htop, hleft, hdiag, x], dim=-1) @ self.Wrz_kernel + self.Wrz_bias
        rl, rt, rd, zi, zl, zt, zd = torch.split(rz, self.hidden, dim=-1)
        z = torch.softmax(torch.stack([zi, zl, zt, zd]), dim=0)
        # the reference's gate order [rl, rt, rd] multiplies the neighbours [h_top, h_left, h_diag]
        r = torch.sigmoid(torch.cat([rl, rt, rd], dim=-1))
        h1 = torch.tanh(x @ self.W_kernel + self.W_bias
                        + (r * torch.cat([htop, hleft, hdiag], dim=-1)) @ self.U_kernel + self.U_bias)
        return z[1] * hleft + z[2] * htop + z[3] * hdiag + z[0] * h1

    def forward(self, s):  # s: [N, Q, W, C]
        n, qlen, wlen, _ = s.shape
        rows = torch.arange(qlen, device=s.device)
        zero_row = s.new_zeros(n, 1, self.hidden)
        hm1 = hm2 = s.new_zeros(n, qlen, self.hidden)  # the hidden states on diagonals d - 1 and d - 2
        for d in range(qlen + wlen - 1):
            j = d - rows  # row i's doc position on diagonal d
            x = s[:, rows, j.clamp(0, wlen - 1)]  # [N, Q, C]
            up1 = torch.cat([zero_row, hm1[:, :-1]], dim=1)  # neighbours at row i - 1 (zero at i = 0)
            up2 = torch.cat([zero_row, hm2[:, :-1]], dim=1)
            hnew = self.cell(x, up2, up1, hm1)
            valid = ((j >= 0) & (j < wlen))[None, :, None]
            hm1, hm2 = torch.where(valid, hnew, 0.0), hm1
        return hm1[:, qlen - 1]


class HINTSpatialModel(nn.Module):
    """HiNT (``mode=spatial``): 100-token windows of the document, 3-channel
    spatial tensors (query projection, doc projection, similarity), the XOR
    and cosine matrices each through a forward and a flipped 2-D GRU, window
    evidence accumulated by a bidirectional LSTM whose directions are summed,
    k-max pooled (zero-padded to ``kmax``) and scored."""

    def __init__(self, embedding, hidden=2, lstm_dim=6, kmax=10, window=100):
        super().__init__()
        self.hidden, self.lstm_dim, self.kmax, self.window = hidden, lstm_dim, kmax, window
        self.embedding = _embedding(embedding)
        dim = self.embedding.shape[1]
        self.Ws = nn.Linear(dim, 1)
        self.GRU2d1 = SpatialGRU2D(3, hidden)
        self.GRU2d3 = SpatialGRU2D(3, hidden)
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(4 * hidden, lstm_dim)
        self.OptimizedLSTMCell_1 = OptimizedLSTMCell(4 * hidden, lstm_dim)
        self.Wv = nn.Linear(4 * hidden, lstm_dim)
        self.fc = nn.Linear(lstm_dim * kmax, 1)

    @cudnn_f32()
    def forward(self, querytoks, doctoks, query_idf):
        b, qlen = querytoks.shape
        dlen = doctoks.shape[1]
        m_cos = similarity_matrix(self.embedding, querytoks, doctoks)
        m_xor = exact_match_matrix(querytoks, doctoks)
        # the reference masks the cells where both the query and the doc term are padding
        keep = 1.0 - ((querytoks == 0)[:, :, None] & (doctoks == 0)[:, None, :]).to(torch.float32)
        x_i = self.Ws(_lookup(self.embedding, querytoks))[:, :, 0]  # [B, Q]
        y_j = self.Ws(_lookup(self.embedding, doctoks))[:, :, 0]  # [B, D]

        w = min(self.window, dlen)  # windows clamped for docs shorter than 100 tokens
        p = max(1, dlen // w)
        trunc = p * w

        def windows(m):  # [B, Q, D] -> [B, P, Q, W]
            return m[:, :, :trunc].reshape(b, qlen, p, w).transpose(1, 2)

        def stack_channels(m):  # -> [B * P, Q, W, 3]
            xi = x_i[:, None, :, None].expand(b, p, qlen, w)
            yj = y_j[:, :trunc].reshape(b, p, 1, w).expand(b, p, qlen, w)
            s = torch.stack([xi, yj, windows(m)], dim=-1) * windows(keep)[..., None]
            return s.reshape(b * p, qlen, w, 3)

        both = torch.cat([stack_channels(m_xor), stack_channels(m_cos)], dim=0)  # [2BP, Q, W, 3]
        h_fwd = self.GRU2d1(both)
        h_inv = self.GRU2d3(torch.flip(both, dims=(1, 2)))
        bp = b * p
        e = torch.cat([h_fwd[:bp], h_fwd[bp:], h_inv[:bp], h_inv[bp:]], dim=-1).reshape(b, p, 4 * self.hidden)

        out = run_rnn((self.OptimizedLSTMCell_0, self.OptimizedLSTMCell_1), e)
        lstm_out = out[..., :self.lstm_dim] + out[..., self.lstm_dim:]  # the reference sums the directions
        vt = torch.tanh(self.Wv(e))
        evidence = torch.cat([vt, lstm_out], dim=1)  # [B, 2P, lstm_dim]
        k = min(self.kmax, evidence.shape[1])
        top = torch.topk(evidence.transpose(1, 2), k, dim=-1).values  # [B, lstm_dim, k]
        if k < self.kmax:  # zero-padded to the fc layer's lstm_dim * kmax
            top = torch.cat([top, top.new_zeros(b, self.lstm_dim, self.kmax - k)], dim=-1)
        return self.fc(top.reshape(b, -1))[:, 0]


class HINTModel(nn.Module):
    """HINT ``mode=windowed``: per 20-token window of the similarity matrix its
    max and mean per query term, accumulated by ``depth`` stacked BiGRUs,
    k-max pooled over the windows and scored."""

    def __init__(self, embedding, maxqlen, maxdoclen, lstm_dim=6, kmax=10, window=20, depth=2):
        super().__init__()
        self.kmax, self.window = kmax, window
        self.embedding = _embedding(embedding)
        self.n_win = max(1, maxdoclen // window)
        self.depth = max(1, depth)
        for i in range(self.depth):
            self.add_module(f"accumulate_{i}", _BiGRU(2 * maxqlen if i == 0 else 2 * lstm_dim, lstm_dim))
        self.combine = nn.Linear(2 * lstm_dim * min(kmax, self.n_win), lstm_dim * 4)
        self.output = nn.Linear(lstm_dim * 4, 1)

    @cudnn_f32()
    def forward(self, querytoks, doctoks, query_idf):
        sim = similarity_matrix(self.embedding, querytoks, doctoks)  # [B, Q, D]
        b, q, d = sim.shape
        n_win = max(1, d // self.window)
        windows = sim[:, :, : n_win * self.window].reshape(b, q, n_win, self.window)
        seq = torch.cat([windows.amax(dim=3), windows.mean(dim=3)], dim=1).transpose(1, 2)  # [B, n_win, 2Q]
        for i in range(self.depth):
            seq = getattr(self, f"accumulate_{i}")(seq)  # [B, n_win, 2 * lstm_dim]
        top = torch.topk(seq.transpose(1, 2), min(self.kmax, seq.shape[1]), dim=-1).values
        return self.output(torch.tanh(self.combine(top.reshape(b, -1))))[:, 0]


@Reranker.register
class HINT(ZooReranker):
    """Yixing Fan et al. 2018. Modeling Diverse Relevance Patterns in Ad-hoc Retrieval.
    ``mode=spatial`` (the default) runs the 2-D spatial GRU; ``mode=windowed``
    the BiGRU stand-in."""

    module_name = "HINT"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="slowembedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("spatialGRU", 2, "2D spatial GRU hidden size; in mode=windowed, the BiGRU stack depth"),
        ConfigOption("LSTMdim", 6, "recurrent hidden size"),
        ConfigOption("kmax", 10, "k-max signals kept"),
        ConfigOption("mode", "spatial", "spatial (anti-diagonal 2D GRU) or windowed (BiGRU accumulation stand-in)"),
    ]

    def build(self):
        if self.config["mode"] not in ("spatial", "windowed"):
            raise ConfigError(f"HINT.mode must be 'spatial' or 'windowed', got {self.config['mode']!r}")

    def build_model(self):
        if not hasattr(self, "model"):
            c, e = self.config, self.extractor.config
            if c["mode"] == "spatial":
                self.model = HINTSpatialModel(self.extractor.embeddings, hidden=int(c["spatialGRU"]),
                                              lstm_dim=c["LSTMdim"], kmax=c["kmax"])
            else:
                self.model = HINTModel(self.extractor.embeddings, e["maxqlen"], e["maxdoclen"], lstm_dim=c["LSTMdim"],
                                       kmax=c["kmax"], depth=int(c["spatialGRU"]))
        return self.model


# ------------------------------------------------------------------------- TK
def positional_encoding(length: int, dim: int) -> np.ndarray:
    """The sinusoidal positional encoding [length, dim], in f32 numpy as the JAX model builds it."""
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim))
    pe = np.zeros((length, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe


class DenseGeneral(nn.Linear):
    """flax ``DenseGeneral`` from ``flax_in_shape`` to ``flax_out_shape`` as an
    ``nn.Linear`` over the flattened shapes (``convert`` maps its kernel)."""

    def __init__(self, in_shape, out_shape):
        super().__init__(int(np.prod(in_shape)), int(np.prod(out_shape)))
        self.flax_in_shape, self.flax_out_shape = tuple(in_shape), tuple(out_shape)


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, key mask):
    query, key and value ``DenseGeneral`` [E] -> [H, D], the query scaled by
    1/√D, masked logits at f32's lowest value, softmax over the keys, the
    ``out`` ``DenseGeneral`` [H, D] -> [E]."""

    def __init__(self, dim, heads, qkv_features):
        super().__init__()
        self.heads, self.head_dim = heads, qkv_features // heads
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral((dim,), (heads, self.head_dim)))
        self.out = DenseGeneral((heads, self.head_dim), (dim,))

    def forward(self, x, key_mask):
        b, length, _ = x.shape
        q, k, v = (getattr(self, n)(x).reshape(b, length, self.heads, self.head_dim) for n in ("query", "key", "value"))
        q = q / torch.sqrt(torch.tensor(self.head_dim, dtype=q.dtype, device=q.device))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(key_mask[:, None, None, :], logits, torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(b, length, -1))


class TKModel(nn.Module):
    """TK: ``numlayers`` transformer layers over the embeddings plus the
    sinusoidal encoding, mixed with the static embeddings by ``alpha``, then
    KNRM's kernel pooling of the cosine matrix. ``projdim`` is declared and
    not read, as in the JAX model."""

    def __init__(self, embedding, projdim=32, ffdim=100, numlayers=2, numattheads=10, alpha=0.5, singlefc=True,
                 scoretanh=False, gradkernels=True, finetune=False):
        super().__init__()
        self.numlayers, self.alpha, self.singlefc, self.scoretanh = numlayers, alpha, singlefc, scoretanh
        self.embedding = _embedding(embedding, trainable=finetune)
        self.mus = nn.Parameter(torch.tensor(KNRM_MUS, dtype=torch.float32), requires_grad=gradkernels)
        self.sigmas = nn.Parameter(torch.tensor(KNRM_SIGMAS, dtype=torch.float32), requires_grad=gradkernels)
        dim = self.embedding.shape[1]
        att_dim = max(numattheads, (dim // numattheads) * numattheads)
        for i in range(numlayers):
            self.add_module(f"att_{i}", MultiHeadDotProductAttention(dim, numattheads, att_dim))
            self.add_module(f"ff1_{i}", nn.Linear(dim, ffdim))
            self.add_module(f"ff2_{i}", nn.Linear(ffdim, dim))
            self.add_module(f"ln1_{i}", nn.LayerNorm(dim, eps=1e-6))  # flax's epsilon
            self.add_module(f"ln2_{i}", nn.LayerNorm(dim, eps=1e-6))
        if singlefc:
            self.combine = nn.Linear(len(KNRM_MUS), 1)
        else:
            self.combine1 = nn.Linear(len(KNRM_MUS), 30)
            self.combine2 = nn.Linear(30, 1)

    def contextualize(self, x, mask):
        for i in range(self.numlayers):
            x = getattr(self, f"ln1_{i}")(x + getattr(self, f"att_{i}")(x, mask))
            x = getattr(self, f"ln2_{i}")(x + getattr(self, f"ff2_{i}")(torch.relu(getattr(self, f"ff1_{i}")(x))))
        return x

    def mixed(self, toks, dropout_seed, site):
        """alpha * static + (1 - alpha) * contextual; the encoding and its dropout feed only the contextual branch."""
        emb = _lookup(self.embedding, toks)
        pe = torch.from_numpy(positional_encoding(emb.shape[1], emb.shape[2])).to(emb.device)
        pos = dropout(emb + pe[None], 0.1, dropout_seed, site)
        return self.alpha * emb + (1 - self.alpha) * self.contextualize(pos, toks != 0)

    def forward(self, querytoks, doctoks, query_idf=None, dropout_seed=None):
        q_mix, d_mix = self.mixed(querytoks, dropout_seed, 0), self.mixed(doctoks, dropout_seed, 1)
        sim = torch.bmm(cosine_rows(q_mix), cosine_rows(d_mix).transpose(1, 2))
        sim = torch.where((querytoks != 0)[:, :, None] & (doctoks != 0)[:, None, :], sim, 0.0)
        pooled = knrm_pool(sim, self.mus, self.sigmas)
        if self.singlefc:
            scores = self.combine(pooled)
        else:
            scores = self.combine2(torch.tanh(self.combine1(pooled)))
        if self.scoretanh:
            scores = torch.tanh(scores)
        return scores[:, 0]


@Reranker.register
class TK(ZooReranker):
    """Sebastian Hofstaetter et al. 2020. Interpretable & Time-Budget-Constrained
    Contextualization for Re-Ranking. ``projdim``, ``usemask`` and ``usemixer``
    are declared and not read, as in the JAX reranker."""

    module_name = "TK"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="slowembedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("gradkernels", True, "backprop through mus and sigmas"),
        ConfigOption("scoretanh", False, "tanh on the final score"),
        ConfigOption("singlefc", True, "single combination layer"),
        ConfigOption("projdim", 32, "projection size"),
        ConfigOption("ffdim", 100, "transformer feedforward size"),
        ConfigOption("numlayers", 2, "transformer layers"),
        ConfigOption("numattheads", 10, "attention heads"),
        ConfigOption("alpha", 0.5, "static/contextual mixing weight"),
        ConfigOption("usemask", False, "use masking"),
        ConfigOption("usemixer", False, "use mixer"),
        ConfigOption("finetune", False, "fine-tune embeddings"),
    ]
    accepts_rngs = True  # positional-encoding dropout during training

    def build_model(self):
        if not hasattr(self, "model"):
            c = self.config
            self.model = TKModel(self.extractor.embeddings, projdim=c["projdim"], ffdim=c["ffdim"],
                                 numlayers=c["numlayers"], numattheads=c["numattheads"], alpha=c["alpha"],
                                 singlefc=c["singlefc"], scoretanh=c["scoretanh"], gradkernels=c["gradkernels"],
                                 finetune=c["finetune"])
        return self.model

    def trainable(self, path, value):
        name = "/".join(map(str, path))
        if "embedding" in name and not self.config["finetune"]:
            return False
        return self.config["gradkernels"] or not ("mus" in name or "sigmas" in name)


# ------------------------------------------------------------------------- DeepTileBar
class DeepTileBarModel(nn.Module):
    """A (1, 3) convolution over each query term's row of tiles, a BiGRU along
    the tiles whose last position's state (the backward half has seen one tile)
    encodes each row, and three Dense layers over the query's rows."""

    def __init__(self, channels, maxqlen, numberfilter=3, lstmhiddendim=3, hidden1=32, hidden2=16):
        super().__init__()
        self.conv = nn.Conv2d(channels, numberfilter, (1, 3))
        self.row_lstm = _BiGRU(numberfilter, lstmhiddendim)
        self.ffw1 = nn.Linear(maxqlen * 2 * lstmhiddendim, hidden1)
        self.ffw2 = nn.Linear(hidden1, hidden2)
        self.output = nn.Linear(hidden2, 1)

    @cudnn_f32()
    def forward(self, tile_matrix):
        """tile_matrix: [B, channels, Q, ntiles] (the deeptiles extractor's)."""
        h = torch.relu(conv_same(self.conv, tile_matrix)).permute(0, 2, 3, 1)  # [B, Q, T, F]
        b, q, t, f = h.shape
        encoded = self.row_lstm(h.reshape(b * q, t, f))[:, -1, :]  # [B * Q, 2 * dim]
        h = torch.relu(self.ffw1(encoded.reshape(b, -1)))
        h = torch.relu(self.ffw2(h))
        return self.output(h)[:, 0]


@Reranker.register
class DeepTileBar(ZooReranker):
    """Zhiwen Tang, Grace Hui Yang. 2019. DeepTileBars: Visualizing Term Distribution
    for Neural Information Retrieval. Its ``passagelen`` is declared and not
    read (the extractor's sets the tiles), as in the JAX reranker."""

    module_name = "DeepTileBar"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="deeptiles"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("passagelen", 30, "tile length"),
        ConfigOption("numberfilter", 3, "conv filters"),
        ConfigOption("lstmhiddendim", 3, "lstm hidden size"),
        ConfigOption("linearhiddendim1", 32, "first hidden layer"),
        ConfigOption("linearhiddendim2", 16, "second hidden layer"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            c, e = self.config, self.extractor.config
            self.model = DeepTileBarModel(e["tilechannels"], e["maxqlen"], numberfilter=c["numberfilter"],
                                          lstmhiddendim=c["lstmhiddendim"], hidden1=c["linearhiddendim1"],
                                          hidden2=c["linearhiddendim2"])
        return self.model

    def score(self, batch, device, dropout_seed=None):
        return [self.model(self.put(batch, side, device)).reshape(-1) for side in ("posdoc", "negdoc")]

    def test(self, batch, device):
        return self.model(self.put(batch, "posdoc", device)).reshape(-1)
