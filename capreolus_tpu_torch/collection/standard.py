"""Standard collection definitions.

Capability parity with capreolus/collection/: antique, nf,
robust04, msmarcopsg, gov2, cds, covid, covidabstract, codesearchnet, nyt, wapo,
highwire. Licensed corpora (robust04, gov2, nyt, wapo, highwire, cds) must be
supplied via ``collection.path``; freely downloadable ones fetch and convert
automatically (gated offline).
"""

from __future__ import annotations

import tarfile

from capreolus_tpu_torch.collection import Collection
from capreolus_tpu_torch.core import ConfigOption, constants
from capreolus_tpu_torch.utils.common import download_file
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)


@Collection.register
class AntiqueCollection(Collection):
    """ANTIQUE non-factoid QA collection (parity: collection/antique.py)."""

    module_name = "antique"
    collection_type = "tsv"
    _url = "http://ciir.cs.umass.edu/downloads/Antique/antique-collection.txt"

    def download_if_missing(self):
        dest_dir = self.get_cache_path() / "corpus"
        target = dest_dir / "antique-collection.txt"
        if not target.exists():
            download_file(self._url, target)
        return dest_dir


@Collection.register
class NFCollection(Collection):
    """NFCorpus (parity: collection/nf.py): downloads and converts docs to TSV."""

    module_name = "nf"
    collection_type = "tsv"
    _url = "http://www.cl.uni-heidelberg.de/statnlpgroup/nfcorpus/nfcorpus.tar.gz"

    def get_raw_dir(self):
        """Directory containing the raw NFCorpus distribution (queries/qrels/docs)."""
        raw_dir = self.get_cache_path() / "raw" / "nfcorpus"
        if not raw_dir.exists():
            archive = self.get_cache_path() / "raw" / "nfcorpus.tar.gz"
            download_file(self._url, archive)
            with tarfile.open(archive) as tar:
                tar.extractall(self.get_cache_path() / "raw")
        return raw_dir

    def download_if_missing(self):
        corpus_dir = self.get_cache_path() / "corpus"
        target = corpus_dir / "docs.tsv"
        if target.exists():
            return corpus_dir
        raw = self.get_raw_dir()
        corpus_dir.mkdir(parents=True, exist_ok=True)
        seen = set()
        with open(target, "wt", encoding="utf-8") as out:
            for split in ("train", "dev", "test"):
                fn = raw / f"{split}.docs"
                with open(fn, encoding="utf-8", errors="replace") as f:
                    for line in f:
                        if not line.strip():
                            continue
                        docid, text = line.rstrip("\n").split("\t", 1)
                        if docid not in seen:
                            seen.add(docid)
                            out.write(f"{docid}\t{' '.join(text.split())}\n")
        logger.info("converted NFCorpus: %d docs", len(seen))
        return corpus_dir


@Collection.register
class Robust04Collection(Collection):
    """TREC disks 4/5 minus CR (parity: collection/robust04.py). Licensed corpus:
    set collection.path to the TREC document directory."""

    module_name = "robust04"
    collection_type = "trec"

    def download_if_missing(self):
        raise IOError(
            "robust04 (TREC disks 4 and 5) is a licensed corpus; set collection.path "
            "to the directory containing the TREC document files"
        )


@Collection.register
class MSMarcoPsgCollection(Collection):
    """MS MARCO passage collection (parity: collection/msmarco.py:17-66)."""

    module_name = "msmarcopsg"
    collection_type = "tsv"
    is_large_collection = True
    _url = "https://msmarco.blob.core.windows.net/msmarcoranking/collectionandqueries.tar.gz"

    def download_if_missing(self):
        corpus_dir = self.get_cache_path() / "corpus"
        target = corpus_dir / "collection.tsv"
        if target.exists():
            return corpus_dir
        archive = self.get_cache_path() / "raw" / "collectionandqueries.tar.gz"
        download_file(self._url, archive)
        corpus_dir.mkdir(parents=True, exist_ok=True)
        with tarfile.open(archive) as tar:
            tar.extract("collection.tsv", corpus_dir)
        return corpus_dir

    def get_raw_dir(self):
        """Directory with the official queries/qrels files (downloads if needed)."""
        raw_dir = self.get_cache_path() / "raw" / "extracted"
        if not raw_dir.exists():
            archive = self.get_cache_path() / "raw" / "collectionandqueries.tar.gz"
            download_file(self._url, archive)
            raw_dir.mkdir(parents=True, exist_ok=True)
            with tarfile.open(archive) as tar:
                tar.extractall(raw_dir)
        return raw_dir


class _LicensedTrecCollection(Collection):
    collection_type = "trec"

    def download_if_missing(self):
        raise IOError(
            f"{self.module_name} is a licensed corpus; set collection.path to the document directory"
        )


@Collection.register
class Gov2Collection(_LicensedTrecCollection):
    """GOV2 web corpus (parity: collection/gov2.py:15 — TrecwebCollection).

    Trecweb format: DOCHDR blocks (URL + HTTP response headers) are skipped
    and the raw crawled HTML is reduced to visible text (utils/trec.py
    iterate_trecweb_docs), matching Anserini's TrecwebCollection + Jsoup
    pipeline the reference indexes gov2 with.
    """

    module_name = "gov2"
    collection_type = "trecweb"


@Collection.register
class CDSCollection(_LicensedTrecCollection):
    """TREC Clinical Decision Support (parity: collection/cds.py:18 —
    JsonCollection of {"id", "contents"} records; the reference materializes
    contents as title+abstract+body via doc_as_json)."""

    module_name = "cds"
    collection_type = "jsonl"


@Collection.register
class NYTCollection(_LicensedTrecCollection):
    """New York Times annotated corpus (parity: collection/nyt.py:18 —
    JsonCollection of {"id", "contents"} records; the reference materializes
    contents as headline+body via doc_as_json)."""

    module_name = "nyt"
    collection_type = "jsonl"


@Collection.register
class WapoCollection(_LicensedTrecCollection):
    """Washington Post corpus (parity: collection/wapo.py)."""

    module_name = "wapo"
    collection_type = "jsonl"


@Collection.register
class HighwireCollection(_LicensedTrecCollection):
    """Highwire (TREC Genomics) corpus (parity: collection/highwire.py:17 —
    JsonCollection of {"id", "contents"} records; the reference materializes
    contents by joining legal span texts via doc_as_json)."""

    module_name = "highwire"
    collection_type = "jsonl"


@Collection.register
class CovidCollection(Collection):
    """CORD-19 collection with round-based releases (parity: collection/covid.py)."""

    module_name = "covid"
    collection_type = "jsonl"
    config_spec = Collection.config_spec + [
        ConfigOption("round", 3, "TREC-COVID round"),
        ConfigOption("coll_type", "abstract", "abstract, full, or paragraph"),
    ]
    _round_dates = {1: "2020-04-10", 2: "2020-05-01", 3: "2020-05-19", 4: "2020-06-19", 5: "2020-07-16"}

    def download_if_missing(self):
        date = self._round_dates[self.config["round"]]
        url = f"https://ai2-semanticscholar-cord-19.s3-us-west-2.amazonaws.com/historical_releases/cord-19_{date}.tar.gz"
        corpus_dir = self.get_cache_path() / "corpus"
        if (corpus_dir / "docs.jsonl").exists():
            return corpus_dir
        archive = self.get_cache_path() / "raw" / f"cord-19_{date}.tar.gz"
        download_file(url, archive)
        raise IOError(
            f"downloaded {archive}; CORD-19 metadata conversion to jsonl is not automated yet — "
            "extract and convert metadata.csv to docs.jsonl with fields id/contents, or set collection.path"
        )


@Collection.register
class CovidAbstractCollection(CovidCollection):
    """CORD-19 abstracts only (parity: collection/covidabstract.py)."""

    module_name = "covidabstract"


@Collection.register
class CodeSearchNetCollection(Collection):
    """CodeSearchNet corpus, per-language (parity: collection/codesearchnet.py)."""

    module_name = "codesearchnet"
    collection_type = "jsonl"
    config_spec = Collection.config_spec + [
        ConfigOption("lang", "ruby", "language: ruby, go, java, javascript, php, or python"),
    ]

    def download_if_missing(self):
        lang = self.config["lang"]
        url = f"https://s3.amazonaws.com/code-search-net/CodeSearchNet/v2/{lang}.zip"
        raise IOError(
            f"codesearchnet corpus not found; download {url}, convert the jsonl.gz shards to a "
            "jsonl file with fields id/contents, and set collection.path"
        )
