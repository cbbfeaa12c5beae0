"""Standard benchmark definitions.

Capability parity with the reference's benchmark zoo (SURVEY.md §2.5): antique,
cds(.desc), core17(.desc), core18(.desc), covid, covidabstract, genomics, gov2(.desc),
msmarcopsg, codesearchnet_corpus/challenge. Topics/qrels come from their public
sources; static fold splits the reference ships are fetched from the public
capreolus repository (all downloads gated offline with actionable errors).
"""

from __future__ import annotations

from capreolus_tpu_torch.benchmark import Benchmark
from capreolus_tpu_torch.benchmark.downloadable import DownloadableBenchmark
from capreolus_tpu_torch.core import ConfigOption, Dependency

_CAPREOLUS_RAW = "https://raw.githubusercontent.com/capreolus-ir/capreolus/master/capreolus/data"
_TREC = "https://trec.nist.gov/data"


@Benchmark.register
class Antique(DownloadableBenchmark):
    """ANTIQUE non-factoid QA (parity: benchmark/antique.py:17; relevance_level=2)."""

    module_name = "antique"
    dependencies = [Dependency(key="collection", module="collection", name="antique")]
    relevance_level = 2
    topic_url = f"{_CAPREOLUS_RAW}/topics.antique.txt"
    qrel_url = f"{_CAPREOLUS_RAW}/qrels.antique.txt"
    fold_url = f"{_CAPREOLUS_RAW}/antique.json"


@Benchmark.register
class Core17(DownloadableBenchmark):
    """TREC Common Core 2017 over NYT (parity: benchmark/core17.py:10)."""

    module_name = "core17"
    dependencies = [Dependency(key="collection", module="collection", name="nyt")]
    topic_url = f"{_TREC}/core/core_nist.txt"
    qrel_url = f"{_TREC}/core/qrels.txt"
    fold_url = f"{_CAPREOLUS_RAW}/core17_birch_folds.json"


@Benchmark.register
class Core17Desc(Core17):
    module_name = "core17.desc"
    query_type = "desc"


@Benchmark.register
class Core18(DownloadableBenchmark):
    """TREC Common Core 2018 over WaPo (parity: benchmark/core18.py:10)."""

    module_name = "core18"
    dependencies = [Dependency(key="collection", module="collection", name="wapo")]
    topic_url = f"{_TREC}/core/topics2018.txt"
    qrel_url = f"{_TREC}/core/qrels2018.txt"
    fold_url = f"{_CAPREOLUS_RAW}/core18_title_folds.json"


@Benchmark.register
class Core18Desc(Core18):
    module_name = "core18.desc"
    query_type = "desc"
    fold_url = f"{_CAPREOLUS_RAW}/core18_desc_folds.json"


@Benchmark.register
class Gov2Benchmark(DownloadableBenchmark):
    """TREC Terabyte (GOV2) (parity: benchmark/gov2.py:10)."""

    module_name = "gov2"
    dependencies = [Dependency(key="collection", module="collection", name="gov2")]
    topic_url = f"{_CAPREOLUS_RAW}/gov2.topics.701-850.txt"
    qrel_url = f"{_CAPREOLUS_RAW}/gov2.qrels.701-850.txt"
    fold_url = f"{_CAPREOLUS_RAW}/gov2_maxp_folds.json"  # shipped in capreolus_tpu_torch/data


@Benchmark.register
class Gov2Desc(Gov2Benchmark):
    module_name = "gov2.desc"
    query_type = "desc"


@Benchmark.register
class CDS(DownloadableBenchmark):
    """TREC Clinical Decision Support (parity: benchmark/cds.py:12)."""

    module_name = "cds"
    dependencies = [Dependency(key="collection", module="collection", name="cds")]
    topic_url = f"{_CAPREOLUS_RAW}/topics.cds.txt"
    qrel_url = f"{_CAPREOLUS_RAW}/qrels.cds.txt"
    fold_url = f"{_CAPREOLUS_RAW}/cds_5folds.json"


@Benchmark.register
class CDSDesc(CDS):
    module_name = "cds.desc"
    query_type = "desc"


@Benchmark.register
class Genomics(DownloadableBenchmark):
    """TREC Genomics 2004-05 (parity: benchmark/genomics.py:10)."""

    module_name = "genomics"
    fold_url = f"{_CAPREOLUS_RAW}/genomics_5folds.json"  # shipped in capreolus_tpu_torch/data
    dependencies = [Dependency(key="collection", module="collection", name="highwire")]
    topic_url = f"{_CAPREOLUS_RAW}/topics.genomics.txt"
    qrel_url = f"{_CAPREOLUS_RAW}/qrels.genomics.txt"


@Benchmark.register
class Covid(DownloadableBenchmark):
    """TREC-COVID with round-based topics/qrels and optional udel query expansion
    (parity: benchmark/covid.py:22-31)."""

    module_name = "covid"
    dependencies = [Dependency(key="collection", module="collection", name="covid")]
    config_spec = DownloadableBenchmark.config_spec + [
        ConfigOption("round", 3, "TREC-COVID round"),
        ConfigOption("udelqexpand", False, "expand queries with the udel method"),
        ConfigOption("useprevqrels", True, "include qrels from previous rounds"),
    ]
    query_type = "query"

    @property
    def topic_url(self):
        return f"https://ir.nist.gov/covidSubmit/data/topics-rnd{self.config['round']}.xml"

    @property
    def qrel_url(self):
        rnd = self.config["round"]
        return f"https://ir.nist.gov/covidSubmit/data/qrels-covid_d{rnd}_j0.5-{rnd}.txt"

    @property
    def topics(self):
        """TREC-COVID topics come as XML; convert like the reference
        (covid.py:154-181): title from <query>, desc from <question>, with
        optional udel query expansion folding the expanded desc into the
        title."""
        if not hasattr(self, "_topics"):
            text = open(self.topic_file, encoding="utf-8").read()
            if not text.lstrip().startswith("<"):
                from capreolus_tpu_torch.utils.trec import load_trec_topics

                self._topics = load_trec_topics(self.topic_file)
                return self._topics
            import re as _re

            title_d, desc_d = {}, {}
            for m in _re.finditer(r'<topic number="(\d+)".*?</topic>', text, _re.S):
                block, qid = m.group(0), m.group(1)
                def field(tag):
                    fm = _re.search(rf"<{tag}>(.*?)</{tag}>", block, _re.S)
                    return (fm.group(1).strip() if fm else "")
                title, desc = field("query"), field("question")
                if self.config.get("udelqexpand"):
                    from capreolus_tpu_torch.utils.udel import udel_expand

                    title = udel_expand(title, question=desc)
                    desc = " "
                title_d[qid], desc_d[qid] = title, desc
            self._topics = {"title": title_d, "desc": desc_d, "query": title_d}
        return self._topics

    @property
    def qrels(self):
        """When useprevqrels (the reference default), judgments from rounds
        1..round are combined (covid.py:85-108; the round>=3 docid back-mapping
        via the NIST changedIds files is not applied — supply
        benchmark.qrelfile for byte-exact historical reproductions)."""
        if not hasattr(self, "_qrels"):
            from capreolus_tpu_torch.utils.trec import load_qrels

            if self.config.get("qrelfile") or not self.config.get("useprevqrels") or self.config["round"] <= 1:
                self._qrels = load_qrels(self.qrel_file)
            else:
                combined = {}
                for rnd in range(1, int(self.config["round"]) + 1):
                    url = f"https://ir.nist.gov/covidSubmit/data/qrels-covid_d{rnd}_j0.5-{rnd}.txt"
                    fn = self._file(f"qrels_rnd{rnd}", url, "qrelfile")
                    for qid, docs in load_qrels(fn).items():
                        combined.setdefault(qid, {}).update(docs)
                self._qrels = combined
        return self._qrels

    @property
    def fold_file(self):
        # the reference builds this trivial single fold programmatically
        # (covid.py:107), so generating it IS the published behavior
        configured = self.config.get("foldfile")
        return configured or self._single_fold_file()

    def _single_fold_file(self):
        import json as _json

        dest = self._data_dir() / "fold.json"
        if not dest.exists():
            qids = sorted(self.topics[self.query_type])
            dest.write_text(_json.dumps(
                {"s1": {"train_qids": qids, "predict": {"dev": qids, "test": qids}}}))
        return dest


@Benchmark.register
class CovidAbstract(Covid):
    """TREC-COVID over abstracts (parity: benchmark/covidabstract.py:10)."""

    module_name = "covidabstract"
    dependencies = [Dependency(key="collection", module="collection", name="covidabstract")]


@Benchmark.register
class CovidQA(DownloadableBenchmark):
    """CovidQA (parity: benchmark/covid.py:185)."""

    module_name = "covidqa"
    dependencies = [Dependency(key="collection", module="collection", name="covid")]
    topic_url = "https://raw.githubusercontent.com/castorini/pygaggle/master/data/kaggle-lit-review-0.2.json"

    @property
    def topics(self):
        """CovidQA distributes a kaggle-lit-review JSON; queries are the
        sub-category kq/nq names, qids start at 2001 to stay disjoint from the
        TREC-COVID topics (reference covid.py:211-239)."""
        self._parse_kaggle_json()
        return self._topics

    @property
    def qrels(self):
        """Answer document ids become relevance-1 judgments (covid.py:233-235)."""
        self._parse_kaggle_json()
        return self._qrels

    def _parse_kaggle_json(self):
        if hasattr(self, "_topics"):
            return
        import json as _json

        text = open(self.topic_file, encoding="utf-8").read()
        if not text.lstrip().startswith("{"):
            from capreolus_tpu_torch.utils.trec import load_qrels, load_trec_topics

            self._topics = load_trec_topics(self.topic_file)
            self._qrels = load_qrels(self.qrel_file)
            return
        qa = _json.loads(text)
        title, desc, qrels = {}, {}, {}
        qid = 2001
        for cate in qa.get("categories", []):
            for sub in cate.get("sub_categories", []):
                title[str(qid)] = sub.get("kq_name", "")
                desc[str(qid)] = sub.get("nq_name", "")
                for ans in sub.get("answers", []):
                    qrels.setdefault(str(qid), {})[str(ans["id"])] = 1
                qid += 1
        self._topics = {"title": title, "desc": desc, "query": title}
        self._qrels = qrels

    @property
    def qrel_file(self):
        # qrels are derived from the topics JSON unless a file is supplied
        return self.config.get("qrelfile") or self.topic_file

    @property
    def fold_file(self):
        # reference builds the trivial all-qids fold programmatically (covid.py:240)
        configured = self.config.get("foldfile")
        return configured or self._single_fold_file()

    def _single_fold_file(self):
        import json as _json

        dest = self._data_dir() / "fold.json"
        if not dest.exists():
            qids = sorted(self.topics[self.query_type])
            dest.write_text(_json.dumps(
                {"s1": {"train_qids": qids, "predict": {"dev": qids, "test": qids}}}))
        return dest


@Benchmark.register
class CodeSearchNetCorpus(DownloadableBenchmark):
    """CodeSearchNet corpus benchmark, per-language (parity: benchmark/codesearchnet.py:28)."""

    module_name = "codesearchnet_corpus"
    dependencies = [Dependency(key="collection", module="collection", name="codesearchnet")]
    config_spec = DownloadableBenchmark.config_spec + [
        ConfigOption("lang", "ruby", "language: ruby, go, java, javascript, php, or python"),
    ]


@Benchmark.register
class CodeSearchNetChallenge(CodeSearchNetCorpus):
    """CodeSearchNet challenge queries (parity: benchmark/codesearchnet.py:189)."""

    module_name = "codesearchnet_challenge"
    topic_url = "https://raw.githubusercontent.com/github/CodeSearchNet/master/resources/queries.csv"

    @property
    def topics(self):
        """The distributed queries.csv (one query per line after the header)
        becomes sequentially-numbered topics (reference codesearchnet.py:189+);
        the challenge is submission-only, so qrels require a local file."""
        if not hasattr(self, "_topics"):
            lines = [l.strip() for l in open(self.topic_file, encoding="utf-8")]
            if lines and lines[0].lower() in ("query", "queries"):
                lines = lines[1:]
            title = {str(i + 1): q for i, q in enumerate(l for l in lines if l)}
            self._topics = {"title": title, "query": title}
        return self._topics

    @property
    def qrels(self):
        if self.config.get("qrelfile"):
            from capreolus_tpu_torch.utils.trec import load_qrels

            return load_qrels(self.config["qrelfile"])
        raise ValueError("codesearchnet_challenge is a submission benchmark with no "
                         "public qrels (reference codesearchnet.py:189); supply "
                         "benchmark.qrelfile to evaluate locally")
