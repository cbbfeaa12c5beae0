"""Sampler modules: deterministic training/eval sample streams (the JAX
package's ``sampler/__init__.py``, which is framework-free: this is a copy).

``prepare`` splits candidates into rel/neg by qrel label vs relevance_level;
``triplet`` is an infinite (q, pos, neg) stream, ``pair`` alternates pointwise
pos/neg with [0,1]/[1,0] labels, ``LCE`` yields (pos, nneg negatives),
``distill`` adds teacher margins from a run file, ``pred`` deterministically
iterates eval pairs. Every draw comes from the module's seeded numpy ``rng`` in
the JAX package's order, so one seed gives the JAX package's stream.
"""

from __future__ import annotations

import hashlib

import numpy as np

from capreolus_tpu_torch.core import ConfigOption, ModuleBase, import_all_modules, register_module_type
from capreolus_tpu_torch.utils.exceptions import MissingDocError
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@register_module_type
class Sampler(ModuleBase):
    module_type = "sampler"
    requires_random_seed = True

    def prepare(self, qid_to_docids, qrels, extractor, relevance_level=1, **kwargs):
        self.extractor = extractor
        self.qid_to_docids = {qid: list(docids) for qid, docids in qid_to_docids.items()}

        missing = [qid for qid in qid_to_docids if qid not in qrels]
        if missing:
            logger.warning("%d qids in the run are missing from the qrels", len(missing))

        self.qid_to_reldocs = {
            qid: [d for d in docids if qrels.get(qid, {}).get(d, 0) >= relevance_level]
            for qid, docids in self.qid_to_docids.items()
        }
        self.qid_to_negdocs = {
            qid: [d for d in docids if qrels.get(qid, {}).get(d, 0) < relevance_level]
            for qid, docids in self.qid_to_docids.items()
        }
        self.total_samples = 0
        self.clean()

    def get_hash(self):
        raise NotImplementedError

    def _content_hash(self):
        sorted_rep = sorted((qid, tuple(docids)) for qid, docids in self.qid_to_docids.items())
        key_content = f"{self.extractor.get_cache_path()}{sorted_rep}"
        return hashlib.md5(key_content.encode("utf-8")).hexdigest()

    def get_total_samples(self):
        return self.total_samples

    def generate_samples(self):
        raise NotImplementedError

    def __iter__(self):
        return iter(self.generate_samples())


class TrainingSamplerMixin:
    # trainer.negrefresh (ANCE-style hard-negative mining, Xiong et al. 2021
    # "Approximate Nearest Neighbor Negative Contrastive Learning") replaces
    # negative pools mid-training; samplers whose streams read the live pools
    # support it (distill pre-builds teacher-filtered pools and opts out)
    supports_hard_negative_refresh = True

    def hard_negative_pool(self):
        """The ORIGINAL per-qid negative pools (snapshot on first use): mining
        re-scores these with the current model each refresh, so a refresh can
        both shrink and re-grow the live pool without losing candidates."""
        if not hasattr(self, "_orig_negdocs"):
            self._orig_negdocs = {qid: list(docs) for qid, docs in self.qid_to_negdocs.items()}
        return self._orig_negdocs

    def set_hard_negatives(self, qid_to_hardnegs):
        """Replace each qid's live negative pool with model-mined hard negatives
        (trainer.negrefresh). Only docs from the original pool are accepted (the
        qrels split already happened in prepare(), so everything in the pool is
        non-relevant); a qid whose mined list is empty keeps its current pool.
        The triplet/pair/LCE streams read the live pools per drawn sample, so
        the swap takes effect immediately — including under the trainer's
        producer thread (a dict-value replacement is an atomic ref swap)."""
        pool = self.hard_negative_pool()
        replaced = 0
        for qid, hard in qid_to_hardnegs.items():
            if qid not in self.qid_to_negdocs:
                continue
            allowed = set(pool[qid])
            hard = [d for d in hard if d in allowed]
            if hard:
                self.qid_to_negdocs[qid] = hard
                replaced += 1
        logger.info("hard-negative refresh: replaced negative pools for %d/%d qids",
                    replaced, len(self.qid_to_negdocs))
        return replaced

    def clean(self):
        """Drop qids lacking either positive or negative docs (parity: sampler/__init__.py:55-70)."""
        total = 0
        for qid in list(self.qid_to_docids.keys()):
            pos, neg = len(self.qid_to_reldocs[qid]), len(self.qid_to_negdocs[qid])
            if pos == 0 or neg == 0:
                logger.warning("removing training qid=%s with %d positive and %d negative docs", qid, pos, neg)
                del self.qid_to_docids[qid], self.qid_to_reldocs[qid], self.qid_to_negdocs[qid]
            else:
                total += pos * neg
        self.total_samples = total


@Sampler.register
class TrainTripletSampler(TrainingSamplerMixin, Sampler):
    """Infinite (query, posdoc, negdoc) triplet stream."""

    module_name = "triplet"

    def get_hash(self):
        return f"triplet_{self._content_hash()}"

    def generate_samples(self):
        all_qids = sorted(self.qid_to_reldocs)
        if not all_qids:
            raise RuntimeError("TrainTripletSampler has no valid qids")
        while True:
            self.rng.shuffle(all_qids)
            for qid in all_qids:
                posdocid = self.rng.choice(self.qid_to_reldocs[qid])
                negdocid = self.rng.choice(self.qid_to_negdocs[qid])
                try:
                    yield self.extractor.id2vec(qid, posdocid, negdocid, label=[1, 0], training=True)
                except MissingDocError:
                    logger.warning("skipping training triple with missing doc: qid=%s pos=%s neg=%s",
                                   qid, posdocid, negdocid)


@Sampler.register
class DistillTripletSampler(TrainTripletSampler):
    """Triplet stream carrying per-triple TEACHER margins for margin-MSE
    knowledge distillation (trainer.loss=margin_mse, reranker/common.py
    margin_mse_loss): teacher_margin = t(pos) - t(neg) where t comes from a
    teacher score file — a TREC run written by a trained cross-encoder's
    predict pass (the Hofstaetter et al. 2020 recipe for distilling a
    cross-encoder into a bi-encoder). Triples where either doc lacks a teacher
    score are skipped (and the qid dropped if either pool empties). Beyond the
    reference, which has no distillation machinery."""

    module_name = "distill"
    # the teacher-filtered pools are pre-built in generate_samples, so a live
    # pool swap would silently do nothing — the trainer raises instead
    supports_hard_negative_refresh = False
    config_spec = [
        ConfigOption("teacherrunfile", "", "TREC run file with teacher scores over the "
                     "training candidates (alternatively pass teacher_scores to prepare())"),
    ]

    def prepare(self, qid_to_docids, qrels, extractor, relevance_level=1,
                teacher_scores=None, **kwargs):
        super().prepare(qid_to_docids, qrels, extractor,
                        relevance_level=relevance_level, **kwargs)
        if teacher_scores is None:
            fn = self.config.get("teacherrunfile") or ""
            if not fn:
                from capreolus_tpu_torch.core import ConfigError

                raise ConfigError("sampler.name=distill needs sampler.teacherrunfile "
                                  "(or teacher_scores passed to prepare())")
            from capreolus_tpu_torch.searcher import Searcher

            teacher_scores = Searcher.load_trec_run(fn)
        # normalize qid/docid keys to str so run dicts with non-string ids
        # (direct teacher_scores callers) look up consistently
        self.teacher_scores = {str(qid): {str(d): float(s) for d, s in docs.items()}
                               for qid, docs in teacher_scores.items()}

    def get_hash(self):
        t = hashlib.md5(str(sorted((q, sorted(d.items()))
                                   for q, d in self.teacher_scores.items())).encode()).hexdigest()
        return f"distill_{t[:12]}_{self._content_hash()}"

    def generate_samples(self):
        all_qids = sorted(self.qid_to_reldocs)
        if not all_qids:
            raise RuntimeError("DistillTripletSampler has no valid qids")
        # teacher-filtered candidate pools are static after prepare(): build
        # them ONCE, not per drawn triple (this loop feeds the device prefetch
        # queue — O(|pool|) membership tests per sample would sit on that path)
        pools = {}
        for qid in all_qids:
            t = self.teacher_scores.get(str(qid), {})
            pos = [d for d in self.qid_to_reldocs[qid] if str(d) in t]
            neg = [d for d in self.qid_to_negdocs[qid] if str(d) in t]
            if pos and neg:
                pools[qid] = (pos, neg)
        dropped = set(all_qids) - set(pools)
        if dropped:
            logger.warning("distill sampler: %d qids have no teacher-scored pos/neg pair "
                           "and are dropped: %s", len(dropped), sorted(dropped)[:5])
        if not pools:
            raise RuntimeError("no training qid has teacher scores for both a positive "
                               "and a negative doc — wrong teacherrunfile?")
        usable = sorted(pools)
        while True:
            self.rng.shuffle(usable)
            for qid in usable:
                t = self.teacher_scores[str(qid)]
                pos_pool, neg_pool = pools[qid]
                posdocid = self.rng.choice(pos_pool)
                negdocid = self.rng.choice(neg_pool)
                try:
                    sample = self.extractor.id2vec(qid, posdocid, negdocid, label=[1, 0], training=True)
                except MissingDocError:
                    logger.warning("skipping training triple with missing doc: qid=%s pos=%s neg=%s",
                                   qid, posdocid, negdocid)
                    continue
                sample = dict(sample)
                sample["teacher_margin"] = np.float32(t[str(posdocid)] - t[str(negdocid)])
                yield sample


@Sampler.register
class TrainPairSampler(TrainingSamplerMixin, Sampler):
    """Pointwise pos/neg alternation with [0,1]/[1,0] labels."""

    module_name = "pair"

    def get_hash(self):
        return f"pair_{self._content_hash()}"

    def generate_samples(self):
        all_qids = sorted(self.qid_to_reldocs)
        if not all_qids:
            raise RuntimeError("TrainPairSampler has no valid qids")
        while True:
            self.rng.shuffle(all_qids)
            for qid in all_qids:
                posdocid = self.rng.choice(self.qid_to_reldocs[qid])
                negdocid = self.rng.choice(self.qid_to_negdocs[qid])
                yield self.extractor.id2vec(qid, posdocid, negid=None, label=[0, 1], training=True)
                yield self.extractor.id2vec(qid, negdocid, negid=None, label=[1, 0], training=True)


@Sampler.register
class LCETrainSampler(TrainingSamplerMixin, Sampler):
    """(pos, nneg negatives) groups for localized contrastive estimation."""

    module_name = "LCE"
    config_spec = [ConfigOption("nneg", 7, "number of negative samples")]

    def get_hash(self):
        return f"lce_{self._content_hash()}_nneg_{self.config['nneg']}"

    def generate_samples(self):
        all_qids = sorted(self.qid_to_reldocs)
        if not all_qids:
            raise RuntimeError("LCETrainSampler has no valid qids")
        nneg = self.config["nneg"]
        while True:
            self.rng.shuffle(all_qids)
            for qid in all_qids:
                posdocid = self.rng.choice(self.qid_to_reldocs[qid])
                negdocids = list(self.rng.choice(self.qid_to_negdocs[qid], nneg))
                label = [1] + [0] * nneg
                try:
                    yield self.extractor.id2vec(qid, posdocid, negdocids, label=label, training=True)
                except MissingDocError:
                    logger.warning("skipping LCE sample with missing doc: qid=%s pos=%s", qid, posdocid)


@Sampler.register
class PredSampler(Sampler):
    """Deterministic (qid, docid) iteration for prediction."""

    module_name = "pred"
    requires_random_seed = False

    def get_hash(self):
        return f"dev_{self._content_hash()}"

    def clean(self):
        self.total_samples = sum(
            len(self.qid_to_reldocs[qid]) * len(self.qid_to_negdocs[qid]) for qid in self.qid_to_docids
        )

    def generate_samples(self):
        for qid, docids in self.qid_to_docids.items():
            for docid in docids:
                try:
                    label = [0, 1] if docid in self.qid_to_reldocs[qid] else [1, 0]
                    yield self.extractor.id2vec(qid, docid, label=label, training=False)
                except MissingDocError:
                    logger.error("got no features for prediction: qid=%s docid=%s", qid, docid)
                    raise

    def get_qid_docid_pairs(self):
        for qid, docids in self.qid_to_docids.items():
            for docid in docids:
                yield qid, docid

    def __len__(self):
        return sum(len(docids) for docids in self.qid_to_docids.values())


import_all_modules(__file__, __package__)
