"""Query-biased snippets in the PyTorch port (``analysis/highlight.py`` and
every service's ``snippets``) against the JAX package, on the CPU.

Tolerance: none. Snippets are host string work over the same documents and
the same analyzer, so the port's equal JAX's character for character: the
window, the markers, the ellipses and the HTML escaping.
"""

import html

import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

import capreolus_tpu.analysis.highlight as jax_highlight  # noqa: E402
import capreolus_tpu.serving as jax_serving  # noqa: E402
import capreolus_tpu_torch.analysis.highlight as highlight  # noqa: E402
import capreolus_tpu_torch.serving as port_serving  # noqa: E402
from capreolus_tpu.index import Index as JaxIndex  # noqa: E402
from capreolus_tpu_torch.index import Index  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER  # noqa: E402
from test_torch_index import torch_cache, write_trec_corpus  # noqa: E402,F401

TEXTS = [
    "alpha beta gamma delta epsilon zeta eta theta GAMMA iota",
    '"alpha beta gamma" said someone',
    "gamma <script>alert(1)</script> and a literal <em>tag</em>",
    "",
    "  ...  ",
    "Galaxies collide; the galaxy's arms, galactic dust and GALAXIES again, galaxy.",
]
TERMS = [{"gamma": 1.0}, {"alpha": 1.0, "zeta": 2.5}, {"zzz": 1.0}, {"galaxi": 1.3, "arm": 0.2}]


@pytest.mark.parametrize("window", [1, 3, 4, 30])
def test_best_window_and_make_snippet_equal_jax(window):
    doc = ["a", "x", "x", "q1", "x", "q2", "x", "x", "q1", "q1", "q2", "q2"]
    for terms in ({"q1": 1.0, "q2": 2.0}, {"q1": 1.0, "q2": 5.0}, {}):
        assert highlight.best_window(doc, terms, window) == jax_highlight.best_window(doc, terms, window)
    for text in TEXTS:
        for terms in TERMS:
            for escape in (None, html.escape):
                got = highlight.make_snippet(text, terms, window=window, escape=escape)
                assert got == jax_highlight.make_snippet(text, terms, window=window, escape=escape), (text, terms)
            marked = highlight.make_snippet(text, terms, window=window, mark=("[", "]"), ellipsis=" ~ ")
            assert marked == jax_highlight.make_snippet(text, terms, window=window, mark=("[", "]"), ellipsis=" ~ ")


def test_snippets_for_hits_equal_jax_through_the_index_analyzer(tmpdir_as_cache, torch_cache):
    jax_index = JaxIndex.create("tpu", {"collection": {"name": "dummy"}})
    port_index = Index.create("tpu", {"collection": {"name": "dummy"}})
    hits = [("D003", 1.0), ("D001", 0.5), ("D002", 0.1), ("NOPE", 0.0)]
    for query in ("distant galaxies", "whales in the ocean", "launch", "zzzz"):
        for options in ({}, {"window": 4}, {"html_escape": False, "mark": ("**", "**")}):
            got = highlight.snippets_for_hits(port_index, query, hits, **options)
            assert got == jax_highlight.snippets_for_hits(jax_index, query, hits, **options)
    assert "<em>" in highlight.snippets_for_hits(port_index, "distant galaxies", hits[:1])[0]


def test_every_service_gives_jax_snippets(tmpdir_as_cache, torch_cache):
    corpus = tmpdir_as_cache / "corpus"
    write_trec_corpus(corpus, num_docs=40, seed=9, min_len=10, max_len=60)
    where = dict(collection="dummy", collection_path=str(corpus))
    encoder = dict(allowrandominit=True, maxdoclen=32, maxqlen=8, batch=8, tokenizer=OFFLINE_TOKENIZER)
    sparse = port_serving.RetrievalService.from_config(device="cpu", **where)
    ports = {
        "sparse": sparse,
        "dense": port_serving.DenseRetrievalService.from_config(device="cpu", **where, **encoder),
        "colbert": port_serving.ColbertRetrievalService.from_config(device="cpu", dim=8, **where, **encoder),
        "impact": port_serving.ImpactRetrievalService.from_config(device="cpu", **where, **encoder),
    }
    ports["hybrid"] = port_serving.HybridRetrievalService(sparse, ports["dense"])
    jax_sparse = jax_serving.RetrievalService.from_config(**where)
    jax_hybrid = jax_serving.HybridRetrievalService(jax_sparse, jax_sparse)
    for query in ("w1 w7 galaxy", "w11 orbit", "telescope"):
        hits = sparse.search([query], k=5)[0] + [("T00003", 0.0)]
        want = jax_highlight.snippets_for_hits(jax_sparse.index, query, hits)  # what JAX's embedding services return
        assert jax_sparse.snippets(query, hits) == jax_hybrid.snippets(query, hits) == want
        for name, svc in ports.items():
            assert svc.snippets(query, hits) == want, name
        for name, svc in ports.items():  # each service's own hits
            own = svc.search([query], k=4)[0]
            assert svc.snippets(query, own) == jax_highlight.snippets_for_hits(jax_sparse.index, query, own), name
