"""The port's text segmentation (``analysis/segmentation.py``), its punkt
tokenizer and bertpassage's sentence, pooled and Birch passages against the
JAX package on the CPU. Everything here is exact: the same sentences, the
same TextTiling segments and boundaries, the same feature arrays."""

import json

import numpy as np
import pytest

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()

from capreolus_tpu.analysis import segmentation as jax_seg  # noqa: E402
from capreolus_tpu.extractor import Extractor as JaxExtractor  # noqa: E402
from capreolus_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from capreolus_tpu_torch.analysis import segmentation as seg  # noqa: E402
from capreolus_tpu_torch.extractor import Extractor as TorchExtractor  # noqa: E402
from capreolus_tpu_torch.tokenizer import Tokenizer as TorchTokenizer  # noqa: E402
from test_segmentation import TOPIC_A, TOPIC_B, _two_topic_text  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401

# the texts of tests/test_segmentation.py's splitter tests, and the edge cases of the rules
SENTENCE_TEXTS = [
    "The telescope worked. It found galaxies! Did it really? Yes.",
    "Dr. Smith arrived at 3 p.m. on Jan. 5. He met Mrs. Jones. They left.",
    "J. R. Smith scored 3.5 points. The U.S. team won. Great.",
    'She said "stop." Then she left.',
    "The telescope worked well. Dr. Smith was pleased. It found 3.5 million galaxies. The U.S. team celebrated.",
    "", "   ", "no terminator at all", "Ends with a period.", "e.g. this one. And i.e. that one. Ph.D. students.",
    "Wait... what?! (Really.) [Yes.] 'Quoted.' “Curly.” Next one.", "3.14 is pi. 2.71 is e.",
    "Multiple   spaces.  Tabs\tand\nnewlines.\n\nParagraph two. vs. lowercase after. OK",
]
ABBREVS = sorted(jax_seg._ABBREVIATIONS)


def fuzz_texts(n, seed):
    """Seeded sentences of words, abbreviations, initials, numbers and terminators."""
    rng = np.random.Generator(np.random.PCG64(seed))
    pieces = ["the", "Galaxy", "orbit", "U.S.", "3.5", "J.", "Mr.", "e.g.", "it", "Whale", "(", ")", '"', "'",
              "!", "?", ".", "...", "10", "A.", "ocean", "Dr", "vs."] + [a.capitalize() + "." for a in ABBREVS[:20]]
    out = []
    for _ in range(n):
        words = rng.choice(pieces, size=int(rng.integers(3, 40)))
        text = ""
        for w in words:
            text += w + ("" if rng.random() < 0.15 else (" " if rng.random() < 0.9 else "\n"))
        out.append(text)
    return out


@pytest.mark.parametrize("texts", ["fixed", "fuzz"])
def test_split_sentences_equals_jax(texts):
    for text in SENTENCE_TEXTS if texts == "fixed" else fuzz_texts(300, seed=12):
        assert seg.split_sentences(text) == jax_seg.split_sentences(text), repr(text)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_texttiling_equals_jax(seed):
    text = _two_topic_text(TOPIC_A, TOPIC_B, seed=seed, n_paras=6 + seed)
    for kwargs in ({}, {"k": 6}, {"w": 10, "cutoff_policy": "LC"}, {"smoothing_width": 3}):
        port, jax = seg.TextTilingSegmenter(**kwargs), jax_seg.TextTilingSegmenter(**kwargs)
        assert port.tokenize(text) == jax.tokenize(text), kwargs
        # the boundaries themselves, before they snap to paragraphs
        words = [(m.group(), m.start()) for m in __import__("re").finditer(r"\w+", text.lower())]
        tokseqs = [words[i:i + port.w] for i in range(0, len(words), port.w)]
        gaps = port._gap_scores(tokseqs)
        assert gaps == jax._gap_scores(tokseqs)
        depth = port._depth_scores(gaps)
        assert depth == jax._depth_scores(gaps) and port._boundaries(depth) == jax._boundaries(depth)
    with pytest.raises(ValueError):
        seg.TextTilingSegmenter().tokenize("too short to have paragraphs")


def test_punkt_tokenizer_equals_jax():
    """Without NLTK's punkt data both take the splitter; with it, both take punkt."""
    port, jax = TorchTokenizer.create("punkt"), JaxTokenizer.create("punkt")
    assert (port._punkt is None) == (jax._punkt is None)
    for text in SENTENCE_TEXTS:
        assert port.tokenize(text) == jax.tokenize(text)
    assert port.tokenize(SENTENCE_TEXTS[:3]) == jax.tokenize(SENTENCE_TEXTS[:3])


# ---------------------------------------------------------------- bertpassage passages
@pytest.fixture
def sentence_corpus(tmpdir_as_cache, torch_cache):
    """20 docs of sentences, some longer than a passage, some short."""
    rng = np.random.Generator(np.random.PCG64(7))
    vocab = TOPIC_A + TOPIC_B + ["the", "a", "of", "Dr.", "U.S.", "3.5"]
    docs = []
    for d in range(20):
        sents = []
        for _ in range(int(rng.integers(1, 12))):
            words = list(rng.choice(vocab, size=int(rng.integers(2, 30))))
            sents.append(" ".join([words[0].capitalize()] + words[1:]) + rng.choice([".", "!", "?"]))
        docs.append((f"S{d:03d}", " ".join(sents)))
    path = tmpdir_as_cache / "sentences"
    path.mkdir()
    with open(path / "docs.trec", "wt") as fh:
        for docid, text in docs:
            fh.write(f"<DOC>\n<DOCNO> {docid} </DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n")
    return {"collection": {"name": "dummy", "path": str(path)}, "docids": [d for d, _ in docs],
            "topics": {"1": "telescope galaxy orbit", "2": "whale ocean"}}


def extractor_pair(name, corpus, options):
    cfg = dict(options, tokenizer=OFFLINE_TOKENIZER, index={"collection": corpus["collection"]})
    out = []
    for registry in (JaxExtractor, TorchExtractor):
        ext = registry.create(name, json.loads(json.dumps(cfg)))
        ext.preprocess(list(corpus["topics"]), corpus["docids"], corpus["topics"])
        out.append(ext)
    return out


FEATURE_KEYS = ("pos_bert_input", "pos_mask", "pos_seg", "neg_bert_input", "neg_mask", "neg_seg", "label")
PASSAGE_CASES = [
    ("bertpassage", {"sentences": True, "passagelen": 8, "numpassages": 6, "maxseqlen": 32, "maxqlen": 6}),
    ("pooledbertpassage", {"sentences": True, "passagelen": 8, "numpassages": 4, "maxseqlen": 32}),
    ("pooledbertpassage", {"passagelen": 10, "stride": 5, "numpassages": 4, "maxseqlen": 32}),
    ("birchbertpassage", {"sentences": True, "passagelen": 12, "numpassages": 5, "maxseqlen": 40}),
    ("birchbertpassage", {"passagelen": 20, "stride": 20, "numpassages": 3, "maxseqlen": 40}),
    ("LCEbertpassage", {"sentences": True, "passagelen": 8, "numpassages": 3, "maxseqlen": 32}),
]


@pytest.mark.parametrize("name,options", PASSAGE_CASES,
                         ids=[f"{n}-{'sentences' if o.get('sentences') else 'window'}" for n, o in PASSAGE_CASES])
def test_passage_features_equal_jax(sentence_corpus, name, options):
    """id2vec's arrays for inference, pairwise training (one seeded random
    passage, or every passage for the pooled and Birch extractors) and LCE
    (a stack of negatives), draw for draw."""
    jax_ext, port_ext = extractor_pair(name, sentence_corpus, options)
    assert port_ext.single_training_passage == jax_ext.single_training_passage
    docids = sentence_corpus["docids"]
    for qid in sentence_corpus["topics"]:
        for docid in docids:
            want = jax_ext.id2vec(qid, docid, label=[1, 0], training=False)
            got = port_ext.id2vec(qid, docid, label=[1, 0], training=False)
            for key in FEATURE_KEYS:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{qid} {docid} {key}")
    for i in range(8):
        pos, neg = docids[i], docids[-1 - i]
        want = jax_ext.id2vec("1", pos, neg, label=[1, 0], training=True)
        got = port_ext.id2vec("1", pos, neg, label=[1, 0], training=True)
        for key in FEATURE_KEYS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"training {pos} {neg} {key}")
        want = jax_ext.id2vec("2", pos, docids[i + 1:i + 4], label=[1, 0], training=True)
        got = port_ext.id2vec("2", pos, docids[i + 1:i + 4], label=[1, 0], training=True)
        assert got["negdocid"] == want["negdocid"]
        for key in FEATURE_KEYS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"LCE {pos} {key}")
    if not port_ext.single_training_passage:
        assert got["pos_bert_input"].shape == (options["numpassages"], options["maxseqlen"])


def test_chunk_sent_drops_the_tail_as_the_reference(sentence_corpus):
    """A sentence longer than passagelen keeps only its whole chunks."""
    jax_ext, port_ext = extractor_pair("bertpassage", sentence_corpus, {"sentences": True, "passagelen": 4})
    sentence = "one two three four five six seven eight nine ten"
    assert port_ext._chunk_sent(sentence, 4) == jax_ext._chunk_sent(sentence, 4) == [
        ["one", "two", "three", "four"], ["five", "six", "seven", "eight"]]
    assert port_ext._chunk_sent("short one", 4) == [["short", "one"]]


def test_the_punkt_tokenizer_is_built_once_per_extractor(sentence_corpus, monkeypatch):
    from capreolus_tpu_torch.tokenizer import PunktTokenizer

    built = []
    original = PunktTokenizer.build
    monkeypatch.setattr(PunktTokenizer, "build", lambda self: (built.append(1), original(self))[1])
    _, port_ext = extractor_pair("bertpassage", sentence_corpus, {"sentences": True, "passagelen": 8})
    for docid in sentence_corpus["docids"]:
        port_ext.id2vec("1", docid, label=[1, 0], training=False)
    assert len(built) == 1
