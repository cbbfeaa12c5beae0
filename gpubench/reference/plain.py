"""The plain reference: BM25, the bertpassage features, the BERT encoder
(f32, or with int8 or int4 integer products), monoBERT-MaxP scoring, the
ColBERT query encoder and MaxSim, in plain PyTorch and NumPy.

It imports nothing of the program and takes nothing the program made: it
re-derives the index, the passages, the wordpiece ids, the int8 calibration
and the weights (``lib/weights.py``) from the generated inputs. What it
copies is a definition, written out here: Lucene's SmallFloat doc-length
byte (``index/smallfloat.py``), the offline hash-wordpiece ids (md5 of the
token, as ``tokenizer/__init__.py``'s fallback defines them) and
bertpassage's sliding-window passages. TF32 is off: every f32 product is an
f32 product."""

from __future__ import annotations

import hashlib
import math
import re

import numpy as np
import torch
import torch.nn.functional as F

PAD, UNK, CLS, SEP, MASK = 0, 100, 101, 102, 103
SPECIAL = {"[PAD]": PAD, "[UNK]": UNK, "[CLS]": CLS, "[SEP]": SEP, "[MASK]": MASK}


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- tokens
def word_tokens(text):
    return re.findall(r"[^\W_]+|[^\w\s]", text.lower())


def wordpiece_id(tok, cache={}, vocab_size=30522):
    i = SPECIAL.get(tok)
    if i is None:
        i = cache.get(tok)
        if i is None:
            i = cache[tok] = 1000 + int(hashlib.md5(tok.encode("utf-8")).hexdigest()[:8], 16) % (vocab_size - 1000)
    return i


# ---------------------------------------------------------------- BM25
def _int4(i):
    bits = i.bit_length()
    if bits < 4:
        return i
    shift = bits - 4
    return ((i >> shift) & 0x07) | ((shift + 1) << 3)


def _from_int4(i):
    shift = (i >> 3) - 1
    return (i & 0x07) if shift == -1 else ((i & 0x07) | 0x08) << shift


_FREE = 255 - _int4(2 ** 31 - 1)


def lucene_length(n):
    """A doc length as Lucene's one-byte norm stores and decodes it."""
    b = n if n < _FREE else _FREE + _int4(n - _FREE)
    return b if b < _FREE else _FREE + _from_int4(b - _FREE)


class BM25:
    """BM25 (Lucene 8: idf * tf / (tf + k1 (1 - b + b dl / avgdl)), dl the
    one-byte norm, avgdl over exact lengths) over whitespace-lowercased text,
    stopwords kept, no stemming, in f64."""

    def __init__(self, docs, k1=0.9, b=0.4):
        self.docids = [d for d, _ in docs]
        self.k1, self.b = k1, b
        postings, lengths = {}, []
        for ordinal, (_, text) in enumerate(docs):
            toks = text.lower().split()
            lengths.append(len(toks))
            words, counts = np.unique(np.asarray(toks), return_counts=True)
            for w, c in zip(words.tolist(), counts.tolist()):
                postings.setdefault(w, ([], []))
                postings[w][0].append(ordinal)
                postings[w][1].append(c)
        self.postings = {w: (np.asarray(o), np.asarray(c, np.float64)) for w, (o, c) in postings.items()}
        lengths = np.asarray(lengths)
        self.n = len(lengths)
        self.avgdl = float(lengths.sum()) / max(1, self.n)
        self.norm = np.asarray([lucene_length(int(x)) for x in lengths], np.float64)

    def scores(self, query):
        out = np.zeros(self.n)
        terms, qtf = np.unique(np.asarray(query.lower().split()), return_counts=True)
        for t, c in zip(terms.tolist(), qtf.tolist()):
            if t not in self.postings:
                continue
            ords, tf = self.postings[t]
            idf = math.log(1.0 + (self.n - len(ords) + 0.5) / (len(ords) + 0.5))
            out[ords] += c * idf * tf / (tf + self.k1 * (1.0 - self.b + self.b * self.norm[ords] / self.avgdl))
        return out

    def top(self, query, k):
        """(ordinals, scores) of the top k with a score above 0, ties to the lower ordinal."""
        s = self.scores(query)
        order = np.lexsort((np.arange(self.n), -s))[:k]
        order = order[s[order] > 0]
        return order, s[order]


# ---------------------------------------------------------------- bertpassage
def passages(text, passagelen, stride, numpassages):
    toks = word_tokens(text)
    out = []
    for i in range(0, max(1, len(toks)), stride):
        if i >= len(toks) and out:
            break
        out.append(toks[i:i + passagelen] or ["[PAD]"])
    out = out[:numpassages]
    out += [["[PAD]"] for _ in range(numpassages - len(out))]
    return out


def passage_inputs(query, texts, ext):
    """(ids, mask, seg) [docs, numpassages, maxseqlen] int64 of ``query`` against ``texts``."""
    qt = word_tokens(query)[:ext["maxqlen"]]
    L = ext["maxseqlen"]
    ids, mask, seg = [], [], []
    for text in texts:
        for psg in passages(text, ext["passagelen"], ext["stride"], ext["numpassages"]):
            line = ["[CLS]"] + qt + ["[SEP]"] + psg[:L - len(qt) - 3] + ["[SEP]"]
            ids.append([wordpiece_id(t) for t in line] + [PAD] * (L - len(line)))
            mask.append([0 if t == "[PAD]" else 1 for t in line] + [0] * (L - len(line)))
            seg.append([0] * (len(qt) + 2) + [1] * (L - len(qt) - 2))
    shape = (len(texts), ext["numpassages"], L)
    return tuple(torch.tensor(x, dtype=torch.int64).view(shape) for x in (ids, mask, seg))


def tf32(x):
    """f32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties to even):
    what a TF32 tensor-core product reads of each operand."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & -0x2000).view(torch.float32)


def tf32_through(x):
    """``tf32`` in the forward, the gradient passed through unrounded: a
    training forward's products at TF32."""
    return x + (tf32(x.detach()) - x.detach())


# ---------------------------------------------------------------- integer products
def scale_of(amax, levels):
    return amax / torch.full_like(amax, float(levels))


def quant_rows(x, levels, floor):
    """Symmetric per-row codes (as f32 values) and f32 scales [..., 1]."""
    s = scale_of(x.abs().amax(dim=-1, keepdim=True).clamp_min(floor), levels)
    return torch.round(x / s).clamp_(-levels, levels), s


def int_product(a, w):
    """a [M, K] @ w [N, K].T of integer codes, exact: f32 products over K
    slices short enough that every partial sum stays below 2**24, summed in
    f64, then rounded to f32 as an int32 converts."""
    step = max(1, int(2 ** 24 // (127 * 127)))
    acc = None
    for k0 in range(0, a.shape[1], step):
        part = (a[:, k0:k0 + step] @ w[:, k0:k0 + step].T).double()
        acc = part if acc is None else acc + part
    return acc.float()


class Quantized:
    """Weight codes per output channel (as f32 values) with their scales."""

    def __init__(self, w, levels, fold=None):
        kf = w if fold is None else w * fold[None, :]
        self.ws = scale_of(kf.abs().amax(dim=1).clamp_min(1e-8), levels)
        self.wq = torch.round(kf / self.ws[:, None]).clamp_(-levels - 1, levels)


# ---------------------------------------------------------------- BERT
class Bert:
    """The BERT encoder of ``model`` over weights ``w`` (``lib/weights.py``'s
    names): post-LN layers, tanh GELU, f32. ``levels`` 127 (int8) or 7 (int4)
    makes every projection and FFN product an integer product: per-token
    codes of the input, per-channel codes of the weight, the GELU output
    requantized per channel at scales calibrated by ``calibrate`` (amax over
    every position of a batch, 8 where a channel never fired) and folded into
    the down-projection's weight. ``products`` (``tf32``, say) rounds both
    operands of every f32 product: a control one precision down. ``drop(x,
    *path)`` is a training forward's dropout at each site: path (0,) after the
    embeddings, (layer + 1, 0) on the attention probabilities, (layer + 1, 1)
    on the attention output, (layer + 1, 2) on the FFN output."""

    def __init__(self, model, w, levels=None, products=None, drop=None):
        self.m, self.w, self.levels = model, w, levels
        self.mm = products or (lambda x: x)
        self.drop = drop or (lambda x, *path: x)
        self.n_layers, self.heads = model["num_hidden_layers"], model["num_attention_heads"]
        self.gelu_amax = [None] * self.n_layers
        self.q = {}
        if levels:
            for i in range(self.n_layers):
                for name in ("q", "k", "v", "o", "ffn_in"):
                    self.q[f"layer{i}.{name}"] = Quantized(w[f"layer{i}.{name}.w"], levels)

    def _gelu_scales(self, i):
        amax = self.gelu_amax[i]
        return scale_of(torch.where(amax > 0, amax, torch.full_like(amax, 8.0)), self.levels)

    def _linear(self, x, name, x_pre=None):
        b = self.w[name + ".b"]
        if not self.levels:
            return self.mm(x) @ self.mm(self.w[name + ".w"]).T + b
        qw = self.q[name]
        if x_pre is None:
            xq, xs = quant_rows(x, self.levels, 1e-6)
            return int_product(xq, qw.wq) * xs * qw.ws + b
        return int_product(x_pre, qw.wq) * qw.ws + b

    def _ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".scale"], self.w[name + ".bias"], 1e-12)

    def embed(self, ids, seg):
        w = self.w
        h = w["emb.word"][ids % w["emb.word"].shape[0]] + w["emb.position"][None, :ids.shape[1]] \
            + w["emb.type"][seg % w["emb.type"].shape[0]]
        return self._ln(h, "emb.ln")

    def layer(self, i, x, mask, calibrate=False):
        p = f"layer{i}."
        b, l, h = x.shape
        d = h // self.heads
        if self.levels:  # one quantization of x feeds q, k and v
            xq, xs = quant_rows(x, self.levels, 1e-6)
            proj = [int_product(xq.view(b * l, h), self.q[p + n].wq).view(b, l, h) * xs * self.q[p + n].ws
                    + self.w[p + n + ".b"] for n in ("q", "k", "v")]
        else:
            proj = [self.mm(x) @ self.mm(self.w[p + n + ".w"]).T + self.w[p + n + ".b"] for n in ("q", "k", "v")]
        q, k, v = (t.view(b, l, self.heads, d).transpose(1, 2) for t in proj)
        s = self.mm(q * (1.0 / math.sqrt(d))) @ self.mm(k).transpose(-1, -2)
        s = s.masked_fill(~mask[:, None, None, :], -1e30)
        probs = self.drop(torch.softmax(s, dim=-1), i + 1, 0)
        ctx = (self.mm(probs) @ self.mm(v)).transpose(1, 2).reshape(b * l, h)
        attn = self.drop(self._linear(ctx, p + "o").view(b, l, h), i + 1, 1)
        x = self._ln(x + attn, p + "attn_ln")
        flat = x.view(b * l, h)
        g = F.gelu(self._linear(flat, p + "ffn_in"), approximate="tanh")
        if calibrate:  # the layer's GELU amax over these rows, for ``calibrate``
            return g.abs().amax(dim=0)
        if self.levels:
            codes = torch.round(g / self._gelu_scales(i)).clamp_(-self.levels, self.levels)
            ff = self._linear(None, p + "ffn_out", x_pre=codes)
        else:
            ff = self._linear(g, p + "ffn_out")
        return self._ln(x + self.drop(ff.view(b, l, h), i + 1, 2), p + "out_ln")

    def calibrate(self, ids, mask, seg, rows):
        """The int8 stats from a whole batch, layer by layer as the program's
        calibrating forward takes them: each layer's GELU amax over every
        position (pad positions included), with the layers below already
        calibrated; then the down-projection's weight with those scales folded in."""
        x = self.embed(ids, seg)
        keys = mask.bool()
        for i in range(self.n_layers):
            blocks = range(0, x.shape[0], rows)
            self.gelu_amax[i] = torch.stack([self.layer(i, x[r:r + rows], keys[r:r + rows], calibrate=True)
                                             for r in blocks]).amax(dim=0)
            key = f"layer{i}.ffn_out"
            self.q[key] = Quantized(self.w[key + ".w"], self.levels, fold=self._gelu_scales(i))
            x = torch.cat([self.layer(i, x[r:r + rows], keys[r:r + rows]) for r in blocks])

    def forward(self, ids, mask, seg):
        x = self.drop(self.embed(ids, seg), 0)
        mask = mask.bool()
        for i in range(self.n_layers):
            x = self.layer(i, x, mask)
        return x


def maxp_scores(bert, w, ids, mask, seg, rows=256, calibrate=False):
    """[docs] MaxP scores of [docs, P, L] inputs: the classifier over the
    tanh pooler of [CLS], the max over every passage (a pad passage counts, as
    bertpassage's [CLS] query [SEP] is never masked). ``rows`` sequences a
    block; ``calibrate`` takes the int8 stats from the whole batch first."""
    n, p, l = ids.shape
    flat = [t.reshape(n * p, l) for t in (ids, mask, seg)]
    if calibrate:
        bert.calibrate(*flat, rows)
    out = []
    for r0 in range(0, n * p, rows):
        hid = bert.forward(*(t[r0:r0 + rows] for t in flat))
        pooled = torch.tanh(bert.mm(hid[:, 0]) @ bert.mm(w["pooler.w"]).T + w["pooler.b"])
        out.append((bert.mm(pooled) @ bert.mm(w["classifier.w"]).T + w["classifier.b"])[:, 0])
    return torch.cat(out).view(n, p).amax(dim=1)


# ---------------------------------------------------------------- ColBERT
def colbert_query_ids(texts, maxqlen):
    """[Q, maxqlen] ids as the query encoder sees them: [CLS] [unused0] tokens
    [SEP], pads as [MASK]."""
    out = torch.full((len(texts), maxqlen), MASK, dtype=torch.int64)
    for i, text in enumerate(texts):
        ids = [CLS] + [wordpiece_id(t) for t in word_tokens(text)[:maxqlen - 2]] + [SEP]
        ids = [ids[0], 1] + ids[1:maxqlen - 1]
        out[i, :len(ids)] = torch.tensor(ids)
    return out


def colbert_queries(bert, w, ids):
    """[Q, Lq, dim] f32 unit query token embeddings (every position attended)."""
    mask = torch.ones_like(ids)
    hid = bert.forward(ids, mask, torch.zeros_like(ids))
    emb = bert.mm(hid) @ bert.mm(w["linear.w"]).T
    return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-9)
