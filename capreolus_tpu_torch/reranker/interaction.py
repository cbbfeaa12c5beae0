"""Interaction-based neural rankers (the JAX package's
``reranker/interaction.py``): TFKNRM, DRMM, DRMMTKS, ConvKNRM, PACRR, DSSM and
CDSSM.

Each model keeps the JAX model's parameter names (``ffw1``, ``conv_2``,
``combine``, ...), so ``convert.flax_state_dict`` carries a JAX parameter tree
across and ``convert.flax_flat_params`` writes one back. Sizes that flax reads
from its inputs at init come from the extractor's config here: DSSM's first
layer from ``bagofwords.feature_dim``, PACRR's ``combine1`` from ``maxqlen``.

The convolutions are flax's ``nn.Conv`` with ``SAME`` padding: channels-last
in JAX, channels-first here (``conv_same``), an even kernel padded 0 before
and 1 after. A forward that reaches cuDNN runs under ``cudnn_f32``. Only a
frozen TFKNRM on the card reaches a hand-written kernel (K1, through the
port's KNRM); every other product here is plain PyTorch, as it is plain XLA in
JAX. Dropout (DSSM's 0.5 between layers, CDSSM's on the convolution) draws
from the port's generators, one site per call (``dropout_seed``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from capreolus_tpu_torch.core import ConfigOption, Dependency
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker.bert.encoder import dropout
from capreolus_tpu_torch.reranker.common import (KNRM_MUS, KNRM_SIGMAS, conv_same, cosine_rows, cudnn_f32,
                                                 knrm_pool, similarity_matrix)
from capreolus_tpu_torch.reranker.knrm import KNRM


def _embedding(table, trainable=False):
    return nn.Parameter(torch.as_tensor(np.asarray(table, dtype=np.float32)), requires_grad=trainable)


def _lookup(embedding, toks):
    """Rows of ``embedding`` for ids ``toks``; negative (OOV) ids read the pad row 0."""
    return embedding[torch.clamp_min(toks, 0)]


def _cosine(q, d):
    """The cosine of each pair of rows of q [B, Q, E] and d [B, D, E] -> [B, Q, D], in f32."""
    return torch.bmm(cosine_rows(q), cosine_rows(d).transpose(1, 2))


class ZooReranker(Reranker):
    """The rerankers of this module and of ``sequence_models.py``: weights
    carried by name through ``convert.flax_state_dict``, a frozen embedding
    table refilled from the extractor's."""

    def state_dict_from_params(self, flat, model=None):
        from capreolus_tpu_torch.convert import flax_state_dict

        model = model if model is not None else self.build_model()
        table = getattr(self.extractor, "embeddings", None)
        refill = {"params/embedding": table} if table is not None else None
        return flax_state_dict(model, flat, refill)

    def trainable(self, path, value):
        return "embedding" not in "/".join(map(str, path))

    score = Reranker.score_default
    test = Reranker.test_default


@Reranker.register
class TFKNRMAlias(KNRM):
    """The reference's TF variant of KNRM: the port's KNRM over slowembedtext
    (frozen, on the card, it runs K1)."""

    module_name = "TFKNRM"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="slowembedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]


# ------------------------------------------------------------------------- DRMM
def histogram_edges(nbins: int) -> np.ndarray:
    """The bins' upper edges, ``jnp.linspace(-1, 1, nbins + 1)[1:]`` bit for bit
    as XLA evaluates it on the CPU: ``t = i * (1 / nbins)`` (the division by a
    constant taken as a product with its f32 reciprocal), then
    ``fma(i, 1 / nbins, -(1 - t))``, one rounding. The f64 arithmetic here is
    exact (a 24-bit by 24-bit product, then a difference of at most 41
    significant bits), so its one cast to f32 is that fma's rounding."""
    i = np.arange(nbins, dtype=np.float32)
    r = np.float32(1.0) / np.float32(nbins)
    u = (np.float32(1.0) - (i * r).astype(np.float32)).astype(np.float32)
    edges = (i.astype(np.float64) * np.float64(r) - u.astype(np.float64)).astype(np.float32)
    return np.concatenate([edges, np.ones(1, np.float32)])[1:]


def matching_histogram(simmat, d_mask, nbins, hist_type):
    """DRMM's matching histograms [B, Q, nbins + 1] (no gradient).

    Bins 0..nbins-1 cover [-1, 1) by strict ``<`` against ``histogram_edges``;
    the last bin counts exact matches (0.999 < sim < 1.001). Pad positions are
    pushed out of every bin. Counts are smoothed (+1), then CH, NH or LCH."""
    sim = simmat + (1.0 - d_mask[:, None, :]) * 1e7
    edges = torch.from_numpy(histogram_edges(nbins)).to(sim.device)
    below = (sim[..., None] < edges).to(sim.dtype).sum(dim=2)  # [B, Q, nbins]
    hist = torch.cat([below[..., :1], torch.diff(below, dim=-1)], dim=-1)
    exact = ((sim > 0.999) & (sim < 1.001)).to(sim.dtype).sum(dim=2, keepdim=True)
    hist = torch.cat([hist, exact], dim=-1) + 1.0
    if hist_type == "NH":
        hist = hist / hist.sum(dim=-1, keepdim=True)
    elif hist_type == "LCH":
        hist = torch.log(hist)
    elif hist_type != "CH":
        raise ValueError("histType should be CH, NH, or LCH")
    return hist.detach()


def _term_gate(gate, gate_type, embedding, querytoks, query_idf):
    """DRMM's term gating: softmax over the query of ``gate`` (a bias-free
    Dense) on each term's idf or embedding, pads at -1e7."""
    q_mask = (querytoks != 0).to(torch.float32)
    if gate_type == "IDF":
        g = gate(query_idf[..., None])[..., 0]
    else:  # TV
        g = gate(_lookup(embedding, querytoks))[..., 0]
    return torch.softmax(g + (1.0 - q_mask) * -1e7, dim=1)


class DRMMModel(nn.Module):
    def __init__(self, embedding, nbins=29, nodes=5, hist_type="LCH", gate_type="IDF"):
        super().__init__()
        self.nbins, self.hist_type, self.gate_type = nbins, hist_type, gate_type
        self.embedding = _embedding(embedding)
        self.ffw1 = nn.Linear(nbins + 1, nodes)
        self.ffw2 = nn.Linear(nodes, 1)
        self.gate = nn.Linear(1 if gate_type == "IDF" else self.embedding.shape[1], 1, bias=False)
        self.output = nn.Linear(1, 1)

    def histograms(self, querytoks, doctoks):
        """The matching histograms [B, Q, nbins + 1]: a step function of the
        similarities (a similarity an ulp either side of an edge moves a count)."""
        simmat = similarity_matrix(self.embedding, querytoks, doctoks)
        return matching_histogram(simmat, (doctoks != 0).to(torch.float32), self.nbins, self.hist_type)

    def score_histograms(self, hist, querytoks, query_idf):
        """Scores [B] from the matching histograms."""
        h = torch.tanh(self.ffw1(hist))
        ffw_vec = torch.tanh(self.ffw2(h))[..., 0]  # [B, Q]
        w = _term_gate(self.gate, self.gate_type, self.embedding, querytoks, query_idf)
        return self.output((w * ffw_vec).sum(dim=-1, keepdim=True))[:, 0]

    def forward(self, querytoks, doctoks, query_idf):
        return self.score_histograms(self.histograms(querytoks, doctoks), querytoks, query_idf)


@Reranker.register
class DRMM(ZooReranker):
    """Jiafeng Guo, Yixing Fan, Qingyao Ai, and W. Bruce Croft. 2016. A Deep Relevance
    Matching Model for Ad-hoc Retrieval. CIKM'16."""

    module_name = "DRMM"
    config_spec = [
        ConfigOption("nbins", 29, "number of bins in the matching histogram"),
        ConfigOption("nodes", 5, "hidden layer size"),
        ConfigOption("histType", "LCH", "histogram type: CH, NH, or LCH"),
        ConfigOption("gateType", "IDF", "term gate type: TV or IDF"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = DRMMModel(self.extractor.embeddings, nbins=self.config["nbins"], nodes=self.config["nodes"],
                                   hist_type=self.config["histType"], gate_type=self.config["gateType"])
        return self.model


# ------------------------------------------------------------------------- DRMMTKS
class DRMMTKSModel(nn.Module):
    def __init__(self, embedding, topk=10, gate_type="IDF", maxdoclen=800, freezeemb=True):
        super().__init__()
        self.topk, self.gate_type = topk, gate_type
        self.embedding = _embedding(embedding, trainable=not freezeemb)
        self.mlp = nn.Linear(min(topk, maxdoclen), 1)
        self.gate = nn.Linear(1 if gate_type == "IDF" else self.embedding.shape[1], 1, bias=False)
        self.output = nn.Linear(1, 1)

    def forward(self, querytoks, doctoks, query_idf):
        simmat = similarity_matrix(self.embedding, querytoks, doctoks)  # [B, Q, D]
        top_sims = torch.topk(simmat, min(self.topk, simmat.shape[-1]), dim=-1).values
        h = torch.tanh(self.mlp(top_sims))[..., 0]
        w = _term_gate(self.gate, self.gate_type, self.embedding, querytoks, query_idf)
        return self.output((w * h).sum(dim=-1, keepdim=True))[:, 0]


@Reranker.register
class DRMMTKS(ZooReranker):
    """DRMM with top-k similarity selection."""

    module_name = "DRMMTKS"
    config_spec = [
        ConfigOption("topk", 10, "number of top similarities kept per query term"),
        ConfigOption("gateType", "IDF", "term gate type: TV or IDF"),
        ConfigOption("freezeemb", True, "freeze the embedding layer"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            self.model = DRMMTKSModel(self.extractor.embeddings, topk=self.config["topk"],
                                      gate_type=self.config["gateType"],
                                      maxdoclen=self.extractor.config["maxdoclen"], freezeemb=self.config["freezeemb"])
        return self.model

    def trainable(self, path, value):
        return not (self.config["freezeemb"] and "embedding" in "/".join(map(str, path)))


# ------------------------------------------------------------------------- ConvKNRM
class ConvKNRMModel(nn.Module):
    def __init__(self, embedding, maxngram=3, filters=128, crossmatch=True, singlefc=True, scoretanh=False,
                 gradkernels=True):
        super().__init__()
        self.maxngram, self.crossmatch, self.singlefc, self.scoretanh = maxngram, crossmatch, singlefc, scoretanh
        self.embedding = _embedding(embedding)
        self.mus = nn.Parameter(torch.tensor(KNRM_MUS, dtype=torch.float32), requires_grad=gradkernels)
        self.sigmas = nn.Parameter(torch.tensor(KNRM_SIGMAS, dtype=torch.float32), requires_grad=gradkernels)
        dim = self.embedding.shape[1]
        for h in range(1, maxngram + 1):
            self.add_module(f"conv_{h}", nn.Conv1d(dim, filters, h))
        pairs = maxngram * maxngram if crossmatch else maxngram
        features = len(KNRM_MUS) * pairs
        if singlefc:
            self.combine = nn.Linear(features, 1)
        else:
            self.combine1 = nn.Linear(features, 30)
            self.combine2 = nn.Linear(30, 1)

    def ngrams(self, emb):
        """tanh of each n-gram convolution of emb [B, L, E] -> [B, L, filters] each."""
        x = emb.transpose(1, 2)
        return [torch.tanh(conv_same(getattr(self, f"conv_{h}"), x)).transpose(1, 2)
                for h in range(1, self.maxngram + 1)]

    @cudnn_f32()
    def forward(self, querytoks, doctoks, query_idf=None):
        q_ngrams = self.ngrams(_lookup(self.embedding, querytoks))
        d_ngrams = self.ngrams(_lookup(self.embedding, doctoks))
        mask = (querytoks != 0)[:, :, None] & (doctoks != 0)[:, None, :]
        pooled = []
        for qi, q_ng in enumerate(q_ngrams):
            for di, d_ng in enumerate(d_ngrams):
                if not self.crossmatch and qi != di:
                    continue
                sim = torch.where(mask, _cosine(q_ng, d_ng), 0.0)
                pooled.append(knrm_pool(sim, self.mus, self.sigmas))
        features = torch.cat(pooled, dim=1)
        if self.singlefc:
            scores = self.combine(features)
        else:
            scores = self.combine2(torch.tanh(self.combine1(features)))
        if self.scoretanh:
            scores = torch.tanh(scores)
        return scores[:, 0]


@Reranker.register
class ConvKNRM(ZooReranker):
    """Zhuyun Dai, Chenyan Xiong, Jamie Callan, Zhiyuan Liu. 2018. Convolutional Neural
    Networks for Soft-Matching N-Grams in Ad-hoc Search. WSDM'18."""

    module_name = "ConvKNRM"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="slowembedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("gradkernels", True, "backprop through mus and sigmas"),
        ConfigOption("maxngram", 3, "maximum ngram length"),
        ConfigOption("crossmatch", True, "match ngrams of different lengths"),
        ConfigOption("filters", 128, "convolution filters"),
        ConfigOption("scoretanh", False, "tanh on the final score"),
        ConfigOption("singlefc", True, "single fully connected combination layer"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            c = self.config
            self.model = ConvKNRMModel(self.extractor.embeddings, maxngram=c["maxngram"], filters=c["filters"],
                                       crossmatch=c["crossmatch"], singlefc=c["singlefc"], scoretanh=c["scoretanh"],
                                       gradkernels=c["gradkernels"])
        return self.model

    def trainable(self, path, value):
        name = "/".join(map(str, path))
        if "embedding" in name:
            return False
        return self.config["gradkernels"] or not ("mus" in name or "sigmas" in name)


# ------------------------------------------------------------------------- PACRR
class PACRRModel(nn.Module):
    def __init__(self, embedding, maxqlen, maxdoclen, mingram=1, maxgram=3, nfilters=32, kmax=2, combine=32,
                 nonlinearity="relu", use_idf=True):
        super().__init__()
        self.mingram, self.maxgram, self.kmax, self.use_idf = mingram, maxgram, kmax, use_idf
        # the config reads "none" as None, which the JAX model's table lacks (it raises there)
        self.nonlin = {"relu": torch.relu, "tanh": torch.tanh, "none": lambda v: v, None: lambda v: v}[nonlinearity]
        self.embedding = _embedding(embedding)
        for n in range(max(2, mingram), maxgram + 1):
            self.add_module(f"conv_{n}", nn.Conv2d(1, nfilters, (n, n)))
        per_term = (maxgram - mingram + 1) * min(kmax, maxdoclen) + int(use_idf)
        self.combine1 = nn.Linear(maxqlen * per_term, combine)
        self.combine2 = nn.Linear(combine, combine)
        self.output = nn.Linear(combine, 1)

    @cudnn_f32()
    def forward(self, querytoks, doctoks, query_idf):
        simmat = similarity_matrix(self.embedding, querytoks, doctoks)  # [B, Q, D]
        signals = []
        for n in range(self.mingram, self.maxgram + 1):
            if n == 1:
                conv_out = simmat
            else:  # max over the filters of relu(conv) -> [B, Q, D]
                conv_out = torch.relu(conv_same(getattr(self, f"conv_{n}"), simmat[:, None])).amax(dim=1)
            signals.append(torch.topk(conv_out, min(self.kmax, conv_out.shape[-1]), dim=-1).values)
        feats = torch.cat(signals, dim=-1)  # [B, Q, ngrams * kmax]
        if self.use_idf:
            idf_softmax = torch.softmax(torch.where(querytoks != 0, query_idf, -1e7), dim=1)
            feats = torch.cat([feats, idf_softmax[..., None]], dim=-1)
        h = self.nonlin(self.combine1(feats.reshape(feats.shape[0], -1)))
        h = self.nonlin(self.combine2(h))
        return self.output(h)[:, 0]


@Reranker.register
class PACRR(ZooReranker):
    """Kai Hui, Andrew Yates, Klaus Berberich, Gerard de Melo. 2017. PACRR: A Position-Aware
    Neural IR Model for Relevance Matching. EMNLP'17."""

    module_name = "PACRR"
    config_spec = [
        ConfigOption("mingram", 1, "minimum ngram length"),
        ConfigOption("maxgram", 3, "maximum ngram length"),
        ConfigOption("nfilters", 32, "convolution filters"),
        ConfigOption("idf", True, "concatenate idf softmax signal"),
        ConfigOption("kmax", 2, "k-max pooling depth"),
        ConfigOption("combine", 32, "combination layer size"),
        ConfigOption("nonlinearity", "relu", "combination nonlinearity: none, relu, or tanh"),
    ]

    def build_model(self):
        if not hasattr(self, "model"):
            c, e = self.config, self.extractor.config
            self.model = PACRRModel(self.extractor.embeddings, e["maxqlen"], e["maxdoclen"], mingram=c["mingram"],
                                    maxgram=c["maxgram"], nfilters=c["nfilters"], kmax=c["kmax"],
                                    combine=c["combine"], nonlinearity=c["nonlinearity"], use_idf=c["idf"])
        return self.model


# ------------------------------------------------------------------------- DSSM
def _cosine_pairs(q, d):
    """The cosine of each row of q [B, H] with the same row of d, as the JAX towers' ``sim``."""
    return (q * d).sum(dim=-1) / ((torch.linalg.vector_norm(q, dim=-1) + 1e-9)
                                  * (torch.linalg.vector_norm(d, dim=-1) + 1e-9))


class DSSMModel(nn.Module):
    """Siamese towers sharing one set of Dense layers ``ffw_i``; the first
    reads the bag-of-words vector (``feature_dim`` wide)."""

    def __init__(self, feature_dim, nhiddens=(56,)):
        super().__init__()
        sizes = (feature_dim,) + tuple(nhiddens)
        for i in range(len(nhiddens)):
            self.add_module(f"ffw_{i}", nn.Linear(sizes[i], sizes[i + 1]))
        self.depth = len(nhiddens)

    def tower(self, x, dropout_seed, side):
        for i in range(self.depth):  # the reference hardcodes Dropout(0.5) between the layers
            x = dropout(torch.tanh(getattr(self, f"ffw_{i}")(x)), 0.5, dropout_seed, side, i)
        return x

    def forward(self, query_vec, doc_vec, dropout_seed=None):
        return _cosine_pairs(self.tower(query_vec, dropout_seed, 0), self.tower(doc_vec, dropout_seed, 1))


@Reranker.register
class DSSM(ZooReranker):
    """Po-Sen Huang et al. 2013. Learning Deep Structured Semantic Models for Web Search
    using Clickthrough Data. CIKM'13."""

    module_name = "DSSM"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="bagofwords"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("nhiddens", "56", "space-separated hidden layer sizes"),
    ]
    accepts_rngs = True  # DSSM trains with dropout between its layers

    def build_model(self):
        if not hasattr(self, "model"):
            sizes = tuple(int(s) for s in str(self.config["nhiddens"]).split())
            self.model = DSSMModel(self.extractor.feature_dim, nhiddens=sizes)
        return self.model

    def score(self, batch, device, dropout_seed=None):
        query = self.put(batch, "query", device)
        return [self.model(query, self.put(batch, side, device), self.fold_seed(dropout_seed, i)).reshape(-1)
                for i, side in enumerate(("posdoc", "negdoc"))]

    def test(self, batch, device):
        return self.model(self.put(batch, "query", device), self.put(batch, "posdoc", device)).reshape(-1)


# ------------------------------------------------------------------------- CDSSM
class CDSSMModel(nn.Module):
    def __init__(self, embedding, nfilter=1, nkernel=3, nhiddens=30, windowsize=3, dropoutrate=0.0):
        super().__init__()
        self.dropoutrate = dropoutrate  # nkernel is declared and not read, as in the JAX model
        self.embedding = _embedding(embedding)
        self.conv = nn.Conv1d(self.embedding.shape[1], nfilter, windowsize)
        self.sem = nn.Linear(nfilter, nhiddens)

    def tower(self, toks, dropout_seed, side):
        h = torch.tanh(conv_same(self.conv, _lookup(self.embedding, toks).transpose(1, 2))).transpose(1, 2)
        h = dropout(h, self.dropoutrate, dropout_seed, side)
        h = torch.where((toks != 0)[..., None], h, -1e7)
        return torch.tanh(self.sem(h.amax(dim=1)))

    @cudnn_f32()
    def forward(self, querytoks, doctoks, query_idf=None, dropout_seed=None):
        return _cosine_pairs(self.tower(querytoks, dropout_seed, 0), self.tower(doctoks, dropout_seed, 1))


@Reranker.register
class CDSSM(ZooReranker):
    """Yelong Shen et al. 2014. A Latent Semantic Model with Convolutional-Pooling Structure
    for Information Retrieval. CIKM'14."""

    module_name = "CDSSM"
    dependencies = [
        Dependency(key="extractor", module="extractor", name="slowembedtext"),
        Dependency(key="trainer", module="trainer", name="jax"),
    ]
    config_spec = [
        ConfigOption("nkernel", 3, "conv kernel dimension"),
        ConfigOption("nfilter", 1, "number of conv filters"),
        ConfigOption("nhiddens", 30, "hidden layer size"),
        ConfigOption("windowsize", 3, "words per conv window"),
        ConfigOption("dropoutrate", 0.0, "dropout rate"),
    ]
    accepts_rngs = True  # CDSSM trains with conv dropout

    def build_model(self):
        if not hasattr(self, "model"):
            c = self.config
            self.model = CDSSMModel(self.extractor.embeddings, nfilter=c["nfilter"], nkernel=c["nkernel"],
                                    nhiddens=c["nhiddens"], windowsize=c["windowsize"], dropoutrate=c["dropoutrate"])
        return self.model
