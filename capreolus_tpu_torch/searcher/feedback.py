"""Feedback and expansion searchers (the JAX package's ``searcher/feedback.py``):

  BM25PRF   BM25 pseudo-relevance feedback: expansion terms selected by
            Robertson offer weight over feedback docs, new terms weighted by
            ``newTermWeight``, rescored with BM25
  axiomatic axiomatic semantic matching: expansion terms scored by a
            deterministic mutual-information signal over R feedback + N*R random docs
  BM25Postprocess  passage-id -> doc max-pool dedup and topn truncation
  SDM       sequential dependence model: the device scores unigrams
            collection-wide, then the bigram window components are computed
            exactly on the host for the top candidates from the positional
            forward index and interpolated (term/ordered/unordered weights
            0.85/0.15/0.05 as in Anserini).

The expansion searchers make two engine calls per batch with the host's
expansion between them; the engine runs on the searcher's ``device``.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from capreolus_tpu_torch.core import ConfigError, ConfigOption, Dependency
from capreolus_tpu_torch.searcher import Searcher
from capreolus_tpu_torch.searcher.tpu import QUERY_BATCH, TpuSearcherBase, _ExpansionSearcherBase, _load_topics_tsv, _ranked
from capreolus_tpu_torch.utils.loginit import get_logger
from capreolus_tpu_torch.utils.trec import max_pool_trec_passage_run

logger = get_logger(__name__)


@Searcher.register
class BM25Postprocess(TpuSearcherBase):
    """BM25 with passage->doc max-pool dedup and top-x truncation."""

    module_name = "BM25Postprocess"
    model = "bm25"
    config_spec = [
        ConfigOption("k1", [0.9], "term saturation", value_type="floatlist"),
        ConfigOption("b", [0.4], "length normalization", value_type="floatlist"),
        ConfigOption("hits", 1000, "hits retrieved per query before pooling"),
        ConfigOption("topn", 1000, "results kept after the filtering/pooling"),
        ConfigOption("dedup", False, "max-pool passage ids (docid.passageid) into docids"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"k1": list(self.config["k1"]), "b": list(self.config["b"])}

    def _write_run(self, run, outfn):
        if self.config["dedup"]:
            run = max_pool_trec_passage_run(run)
        topn = self.config["topn"]
        run = {qid: dict(sorted(docs.items(), key=lambda kv: -kv[1])[:topn]) for qid, docs in run.items()}
        super()._write_run(run, outfn)


@Searcher.register
class DirichletQLAlias(TpuSearcherBase):
    """Anserini-compatible name for QL with Dirichlet smoothing."""

    module_name = "DirichletQL"
    model = "qld"
    config_spec = [
        ConfigOption("mu", [1000], "smoothing parameter", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        return {}, {"mu": list(self.config["mu"])}


@Searcher.register
class BM25PRF(_ExpansionSearcherBase):
    """BM25 pseudo-relevance feedback."""

    module_name = "BM25PRF"
    config_spec = [
        ConfigOption("k1", [0.65, 0.70, 0.75], "term saturation", value_type="floatlist"),
        ConfigOption("b", [0.60, 0.7], "length normalization", value_type="floatlist"),
        ConfigOption("fbTerms", [65, 70, 95, 100], "number of feedback terms", value_type="intlist"),
        ConfigOption("fbDocs", [5, 10, 15], "feedback depth", value_type="intlist"),
        ConfigOption("newTermWeight", [0.2, 0.25], "weight of expansion terms", value_type="floatlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def combo_grid(self):
        c = self.config
        for k1, b, fbt, fbd, ntw in itertools.product(c["k1"], c["b"], c["fbTerms"], c["fbDocs"], c["newTermWeight"]):
            yield {"k1": k1, "b": b, "fbTerms": fbt, "fbDocs": fbd, "newTermWeight": ntw}

    def expand_query(self, terms, fb_scores, fb_ords, data, combo):
        if not terms:
            return terms
        n_docs = data.num_docs
        valid_ords = fb_ords[fb_scores > 0]
        r = max(1, len(valid_ords))
        # per-term feedback document frequency
        rt = {}
        for ord_ in valid_ords:
            s, e = data.fwd_offsets[ord_], data.fwd_offsets[ord_ + 1]
            for tid in data.fwd_term_ids[s:e]:
                rt[int(tid)] = rt.get(int(tid), 0) + 1
        df = data.df_array
        scored = []
        for tid, r_t in rt.items():
            nt = float(df[tid])
            # Robertson offer weight: r_t * RSJ term weight
            rsj = math.log(((r_t + 0.5) * (n_docs - nt - r + r_t + 0.5)) / ((nt - r_t + 0.5) * (r - r_t + 0.5)))
            scored.append((r_t * rsj, tid))
        scored.sort(reverse=True)
        original = dict(terms)
        expanded = dict(original)
        for _, tid in scored[: int(combo["fbTerms"])]:
            if tid not in expanded:
                expanded[tid] = combo["newTermWeight"]
        return sorted(expanded.items())


@Searcher.register
class AxiomaticSemanticMatching(_ExpansionSearcherBase):
    """Axiomatic semantic-matching expansion.

    Deterministic variant: expansion terms are scored by a mutual-information
    signal between query terms and candidate terms over the R feedback docs plus
    N*R deterministically-sampled background docs.
    """

    module_name = "axiomatic"
    config_spec = [
        ConfigOption("k1", [0.9], "term saturation", value_type="floatlist"),
        ConfigOption("b", [0.4], "length normalization", value_type="floatlist"),
        ConfigOption("r", [20], "reranking pool size", value_type="intlist"),
        ConfigOption("n", [30], "background docs per feedback doc", value_type="intlist"),
        ConfigOption("beta", [0.4], "expansion interpolation weight", value_type="floatlist"),
        ConfigOption("top", [20], "number of expansion terms", value_type="intlist"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def combo_grid(self):
        c = self.config
        for k1, b, r, n, beta, top in itertools.product(c["k1"], c["b"], c["r"], c["n"], c["beta"], c["top"]):
            yield {"k1": k1, "b": b, "fbDocs": r, "n": n, "beta": beta, "top": top}

    def expand_query(self, terms, fb_scores, fb_ords, data, combo):
        if not terms:
            return terms
        fb = list(fb_ords[fb_scores > 0])
        if not fb:
            return terms
        # deterministic background sample seeded by the feedback docs
        rng = np.random.Generator(np.random.PCG64(int(fb[0])))
        background = list(rng.integers(0, data.num_docs, size=int(combo["n"]) * len(fb)))
        pool = fb + background
        query_tids = {tid for tid, _ in terms}

        presence = {}
        for ord_ in pool:
            s, e = data.fwd_offsets[ord_], data.fwd_offsets[ord_ + 1]
            for tid in set(int(t) for t in data.fwd_term_ids[s:e]):
                presence.setdefault(tid, set()).add(int(ord_))

        m = len(pool)
        scores = {}
        q_sets = [presence.get(tid, set()) for tid in query_tids]
        for tid, docs_with_t in presence.items():
            if tid in query_tids:
                continue
            pt = len(docs_with_t) / m
            mi = 0.0
            for qs in q_sets:
                pq = len(qs) / m
                pj = len(docs_with_t & qs) / m
                if pj > 0 and pq > 0 and pt > 0:
                    mi += pj * math.log(pj / (pt * pq))
            if mi > 0:
                scores[tid] = mi
        top_terms = sorted(scores.items(), key=lambda kv: -kv[1])[: int(combo["top"])]
        expanded = dict(terms)
        total = sum(w for _, w in top_terms) or 1.0
        for tid, w in top_terms:
            expanded[tid] = expanded.get(tid, 0.0) + combo["beta"] * w / total
        return sorted(expanded.items())


@Searcher.register
class SDM(TpuSearcherBase):
    """Sequential dependence model.

    Device-side Dirichlet-QL unigram scoring over the full collection, then exact
    ordered/unordered bigram window counts on the top candidates from the positional
    forward index, interpolated with Anserini's default weights.
    Requires index.storepositions=True.
    """

    module_name = "SDM"
    model = "bm25"
    dependencies = [
        Dependency(key="index", module="index", name="tpu", default_config_overrides={"storepositions": True}),
    ]
    config_spec = [
        ConfigOption("k1", [0.9], "BM25 term saturation", value_type="floatlist"),
        ConfigOption("b", [0.4], "BM25 length normalization", value_type="floatlist"),
        ConfigOption("unigram", "bm25", "unigram/window scoring model: bm25 (Anserini/Lucene SDM "
                     "semantics) or qld (the original Metzler-Croft Indri formulation)"),
        ConfigOption("mu", [1000], "Dirichlet smoothing (unigram=qld only)", value_type="floatlist"),
        ConfigOption("tw", 0.85, "term weight"),
        ConfigOption("ow", 0.15, "ordered window weight"),
        ConfigOption("uw", 0.05, "unordered window weight"),
        ConfigOption("ows", 1, "ordered window size (gap)"),
        ConfigOption("uws", 8, "unordered window size"),
        ConfigOption("hits", 1000, "number of results"),
        ConfigOption("fields", "title", "query fields"),
    ]

    def grid_params(self):
        if self.config["unigram"] == "qld":
            return {}, {"mu": list(self.config["mu"])}
        return {}, {"k1": list(self.config["k1"]), "b": list(self.config["b"])}

    def _search_all(self, topicsfn, output_path):
        engine = self.get_engine()
        if not self.index.config.get("storepositions"):
            raise ValueError("SDM requires index.storepositions=True")
        topics = _load_topics_tsv(topicsfn)
        hits = min(int(self.config["hits"]), engine.dindex.num_docs)
        rescore_depth = min(engine.dindex.num_docs, max(hits, 2 * hits))
        c = self.config
        if c["unigram"] not in ("bm25", "qld"):
            raise ConfigError(f"SDM unigram must be 'bm25' or 'qld', got {c['unigram']!r}")
        qld = c["unigram"] == "qld"
        model = "qld" if qld else "bm25"
        combos = ([{"mu": mu} for mu in c["mu"]] if qld
                  else [{"k1": k1, "b": b} for k1 in c["k1"] for b in c["b"]])

        for params in combos:
            run = {}
            for start in range(0, len(topics), QUERY_BATCH):
                batch = topics[start : start + QUERY_BATCH]
                analyzed = [self.index.analyze(text) for _, text in batch]
                term_lists = [self.query_weights(text, engine) for _, text in batch]
                scores, doc_ords = self._search_batch(engine, term_lists, model, params, rescore_depth)
                for qi, (qid, _) in enumerate(batch):
                    if not term_lists[qi]:
                        continue
                    run[qid] = self._sdm_rescore(analyzed[qi], scores[qi], doc_ords[qi], params, hits)
            tag = self._param_tag({}, params)
            self._write_run(run, output_path / tag)
            logger.info("wrote SDM run file %s", output_path / tag)

    def _sdm_rescore(self, query_terms, uni_scores, doc_ords, params, hits):
        """Window pseudo-term scoring per candidate doc.

        unigram=bm25: Lucene BM25 formula with the window clause's df bounded by
        the rarer constituent term (Lucene computes the true window df during
        evaluation; min(df1, df2) is its upper bound, so the idf is a documented
        lower bound). unigram=qld: Dirichlet with a 1/|C| collection prior."""
        data = self.index.data
        vocab = data.vocab
        tids = [vocab[t] for t in query_terms if t in vocab]
        bigrams = list(zip(tids, tids[1:]))
        c = self.config
        df = data.df_array
        qld = c["unigram"] == "qld"
        # per-combo / per-bigram constants hoisted out of the per-doc loop
        if qld:
            mu = params["mu"]
            prior = 1.0 / float(data.total_term_count)

            def window_score(count, dl, idf):
                return math.log((count + mu * prior) / (dl + mu))

            idfs = [0.0] * len(bigrams)
        else:
            k1, b, avgdl, n = params["k1"], params["b"], data.avgdl, float(data.num_docs)

            def window_score(count, dl, idf):
                return idf * count / (count + k1 * (1.0 - b + b * dl / avgdl))

            idfs = [math.log(1.0 + (n - dfb + 0.5) / (dfb + 0.5))
                    for dfb in (max(1.0, float(min(df[t1], df[t2]))) for t1, t2 in bigrams)]

        results = {}
        valid = uni_scores > 0
        for score, ord_ in zip(uni_scores[valid], doc_ords[valid]):
            sdm_score = c["tw"] * float(score)
            if bigrams:
                tokens = self.index.get_doc_term_ids(int(ord_))
                dl = max(1, len(tokens))
                for (t1, t2), idf in zip(bigrams, idfs):
                    od, uw = _window_counts(tokens, t1, t2, c["ows"], c["uws"])
                    sdm_score += c["ow"] * window_score(od, dl, idf)
                    sdm_score += c["uw"] * window_score(uw, dl, idf)
            results[data.docid_strings[int(ord_)]] = sdm_score
        return dict(sorted(results.items(), key=lambda kv: -kv[1])[:hits])


def _window_counts(tokens, t1, t2, ordered_gap, unordered_window):
    """Counts of ordered (t1 then t2, within gap) and unordered (both within window)."""
    pos1 = np.where(tokens == t1)[0]
    pos2 = np.where(tokens == t2)[0]
    if len(pos1) == 0 or len(pos2) == 0:
        return 0, 0
    diffs = pos2[None, :] - pos1[:, None]
    # Indri/Anserini #odN semantics: t2 follows t1 with diff in [1, N] (diff == 1
    # means adjacent), so ows=1 counts only adjacent pairs
    ordered = int(((diffs >= 1) & (diffs <= ordered_gap)).sum())
    unordered = int((np.abs(diffs) < unordered_window).sum())
    return ordered, unordered
