"""The learned-sparse impact searcher of the PyTorch port
(``searcher/impact.py`` over the port's sparse engine) against the JAX
package on the CPU, over the 126-doc corpus of ``torch_dense_util.py`` with
the JAX searcher's random-init encoder and head carried over as the port's
``checkpointfile``.

Tolerances:
- the engine's ``impact`` model against a numpy referee: 1e-6 relative,
  ties by ascending doc.
- raw impacts (uniCOIL's per-term maxima, SPLADE's reps): 1e-5 relative to
  the largest (the tiny f32 encoder's sums in other orders); term sets equal
  but for terms whose weight is within that of 0 (ReLU's edge) or, for
  SPLADE's ``topterms`` cut, within it of the cut.
- from JAX's raw doc-major cache: the CSR equal, rankings equal ordinal for
  ordinal, scores 1e-6 relative (the sparse engine's contract), fed the same
  query weights.
- train / serve: the reranker's score against the served 16-bit impact dot
  product, 2e-2 (``tests/test_impact.py``).
"""

import shutil

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.core import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER, assert_within  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from torch_dense_util import TOPICS, jax_impact_checkpoint, load_run, searcher_config, write_dense_corpus  # noqa: E402

RAW_TOL = 1e-5
SCORE_RTOL = 1e-6
SERVE_TOL = 2e-2


def impact_config(coll, **options):
    return searcher_config(coll, batch=32, **options)


@pytest.fixture
def world(tmpdir_as_cache, torch_cache):
    return {"coll": write_dense_corpus(tmpdir_as_cache / "corpus"), "tmp": tmpdir_as_cache, "ckpts": {}}


def jax_searcher(world, **options):
    return JaxSearcher.create("impact", impact_config(world["coll"], **options))


def port_searcher(world, encoder="unicoil", **options):
    if encoder not in world["ckpts"]:
        world["ckpts"][encoder] = jax_impact_checkpoint(jax_searcher(world, encoder=encoder),
                                                        world["tmp"] / f"{encoder}.npz")
    s = TorchSearcher.create("impact", impact_config(world["coll"], encoder=encoder,
                                                     **{"checkpointfile": world["ckpts"][encoder], **options}))
    s.device = "cpu"
    return s


def test_impact_engine_math():
    """The engine's ``impact`` model is sum_t qweight * impact over a
    hand-built CSR, top 10 by (score desc, doc asc) (``tests/test_impact.py``)."""
    from capreolus_tpu_torch.index.smallfloat import quantize_lengths
    from capreolus_tpu_torch.index.tpu import IndexData
    from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine

    rng = np.random.default_rng(0)
    n_docs, n_terms = 50, 12
    dense = (rng.random((n_docs, n_terms)) * 8).astype(np.int32)
    dense[rng.random((n_docs, n_terms)) < 0.6] = 0
    terms, docs, quants = [], [], []
    for t in range(n_terms):
        nz = np.nonzero(dense[:, t])[0]
        order = np.lexsort((nz, -dense[nz, t]))
        terms.extend([t] * len(nz))
        docs.extend(nz[order].tolist())
        quants.extend(dense[nz[order], t].tolist())
    term_offsets = np.cumsum(np.bincount(np.asarray(terms) + 1, minlength=n_terms + 1)).astype(np.int64)
    doclens = np.maximum((dense > 0).sum(axis=1).astype(np.int32), 1)
    data = IndexData(term_offsets=term_offsets, doc_ids=np.asarray(docs, np.int32), tfs=np.asarray(quants, np.int32),
                     doclens=doclens, norm_doclens=quantize_lengths(doclens),
                     docid_strings=[f"D{i}" for i in range(n_docs)], vocab={})
    engine = ScoringEngine(DeviceIndex(data, device="cpu"))
    queries = [[(0, 1.5), (3, 0.25), (7, 2.0)], [(1, 1.0)], [(5, 0.5), (5, 0.5)]]
    scores, ords = engine.search(queries, model="impact", params={}, topk=10)
    for qi, q in enumerate(queries):
        expected = np.zeros(n_docs)
        for t, w in q:
            expected += w * dense[:, t]
        order = np.lexsort((np.arange(n_docs), -expected))[:10]
        got = [(int(o), float(s)) for s, o in zip(scores[qi], ords[qi]) if s > 0]
        want = [(int(o), float(expected[o])) for o in order if expected[o] > 0]
        assert [o for o, _ in got] == [o for o, _ in want]
        assert_within([s for _, s in got], [s for _, s in want], SCORE_RTOL, f"impact engine, query {qi}")


def assert_term_weights_match(got, want, cut, what):
    """Per text: weights within RAW_TOL of the largest; the same terms but at
    an edge, where a term kept by one package only weighs within RAW_TOL of
    it: ReLU's 0, or with ``cut`` (SPLADE's ``topterms``) the other list's
    smallest kept weight."""
    scale = max(float(np.max(w)) for _, w in want if len(w))
    for (gt, gw), (wt, ww) in zip(got, want):
        g, w = dict(zip(gt.tolist(), gw.tolist())), dict(zip(wt.tolist(), ww.tolist()))
        for t in g.keys() ^ w.keys():
            mine, other = (g, w) if t in g else (w, g)
            edge = min(other.values()) if cut and other else 0.0
            assert abs(mine[t] - edge) <= RAW_TOL * scale, (what, t, mine[t], edge)
        common = sorted(g.keys() & w.keys())
        assert_within([g[t] / scale for t in common], [w[t] / scale for t in common], RAW_TOL, what)


@pytest.mark.parametrize("encoder,options", [("unicoil", {}), ("splade", {"topterms": 24})])
def test_raw_impacts_match_jax(world, encoder, options):
    port, jx = port_searcher(world, encoder, **options), jax_searcher(world, encoder=encoder, **options)
    port.index.create_index()
    texts = [port.index.get_doc(d) for d in port.index.data.docid_strings[:40]]
    queries = list(TOPICS.values())
    splade = encoder == "splade"
    got_docs = port._doc_term_weights(texts)
    assert_term_weights_match(got_docs, jx._doc_term_weights(texts), splade, encoder)
    if splade:
        assert all(len(t) == 24 for t, _ in got_docs)
    qgot, qwant = port.query_weights_batch(queries), jx.query_weights_batch(queries)
    assert_term_weights_match([(np.array([t for t, _ in q]), np.array([w for _, w in q])) for q in qgot],
                              [(np.array([t for t, _ in q]), np.array([w for _, w in q])) for q in qwant],
                              splade, f"{encoder} query weights")


@pytest.mark.parametrize("encoder,options", [("unicoil", {}), ("unicoil", {"quantbits": 4, "maxpostings": 3}),
                                             ("splade", {"topterms": 24})])
def test_csr_and_rankings_from_jax_cache(world, encoder, options):
    """JAX's raw doc-major cache copied to the port's ``_cache_file``: the
    same CSR (term, impact desc, doc asc), and the same rankings from the
    same query weights, the ``maxpostings`` cap included; the run files'
    scores are the true quantized dot products."""
    jx = jax_searcher(world, encoder=encoder, **options)
    j_engine, j_docids, j_scale = jx._impact_index()
    port = port_searcher(world, encoder, **options)
    port.index.create_index()
    dest = port._cache_file()
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(jx._cache_file(), dest)
    engine, docids, scale = port._impact_index()
    assert docids == list(j_docids) and scale == j_scale
    for key in ("term_offsets", "doc_ids", "tfs", "doclens"):
        np.testing.assert_array_equal(getattr(engine.dindex.host, key), getattr(j_engine.dindex.host, key), key)
    weights = jx.query_weights_batch(list(TOPICS.values()))
    cap = int(options.get("maxpostings", 0))
    got = engine.search(port.term_lists(engine, scale, weights), model="impact", params={}, topk=50,
                        max_postings_per_term=cap)
    nt, offs = j_engine.dindex.num_terms, j_engine.dindex.term_offsets
    want = j_engine.search([[(t, w / j_scale) for t, w in qw if t < nt and offs[t + 1] > offs[t]] for qw in weights],
                           model="impact", params={}, topk=50, max_postings_per_term=cap)
    for qi in range(len(TOPICS)):
        keep = np.asarray(want[0][qi]) > 0
        np.testing.assert_array_equal(np.asarray(got[1][qi])[keep], np.asarray(want[1][qi])[keep])
        assert_within(np.asarray(got[0][qi])[keep], np.asarray(want[0][qi])[keep], SCORE_RTOL, f"query {qi}")


def test_streaming_equals_resident(world):
    """A tiny ``hbmbudget`` streams the impact tiles; the run equals the resident one."""
    topics = world["tmp"] / "t.tsv"
    topics.write_text("".join(f"{q}\t{t}\n" for q, t in TOPICS.items()))
    resident, streamed = port_searcher(world), port_searcher(world, hbmbudget=0.0001)
    run_r = load_run(resident.query_from_file(topics, world["tmp"] / "r"))
    run_s = load_run(streamed.query_from_file(topics, world["tmp"] / "s"))
    assert streamed._impact_index()[0].dindex.streaming and not resident._impact_index()[0].dindex.streaming
    assert run_r == run_s and any(run_r.values())


def test_splade_expands_beyond_literal_tokens(world):
    """``encoder=splade`` indexes terms a document never contains, at most
    ``topterms`` a document; the run's scores are the quantized dot product."""
    searcher = port_searcher(world, "splade", topterms=24)
    engine, docids, scale = searcher._impact_index()
    d = engine.dindex.host
    literal = {t for doc in docids for t in searcher.tokenizer.convert_tokens_to_ids(
        searcher.tokenizer.tokenize(searcher.index.get_doc(doc)))}
    indexed = set(np.nonzero(np.diff(d.term_offsets))[0].tolist())
    assert indexed - literal
    assert d.doclens.max() <= 24
    dense = np.zeros((len(docids), d.num_terms))
    for t in range(d.num_terms):
        docs_t, tfs_t = d.postings(t)
        dense[docs_t, t] = tfs_t
    topics = world["tmp"] / "t.tsv"
    topics.write_text("501\tgalaxy telescope orbit\n")
    run = load_run(searcher.query_from_file(topics, world["tmp"] / "o"))["501"]
    expected = np.zeros(len(docids))
    for t, w in searcher.query_weights("galaxy telescope orbit"):
        if t < d.num_terms:
            expected += (w / scale) * dense[:, t]
    assert_within([run[doc] for doc in run], [expected[docids.index(doc)] for doc in run], 1e-5, "splade run")


@pytest.mark.parametrize("name", ["unicoil", "splade"])
def test_train_serve_parity(world, name):
    """A reranker's weights (the port's init, written by the port's trainer)
    served by the impact searcher at 16 bits (SPLADE untruncated) score each
    (query, doc) as the reranker's own prediction does, up to quantization."""
    import json

    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    cfg = {"pretrained": "tiny", "allowrandominit": True,
           "extractor": {"maxqlen": 8, "maxdoclen": 32, "tokenizer": OFFLINE_TOKENIZER,
                         "index": {"collection": world["coll"]}}}
    rr = Reranker.create(name, json.loads(json.dumps(cfg)))
    model = rr.init_params(9)
    if name == "splade":
        with torch.no_grad():
            model.mlm.decoder.bias.fill_(-3.0)  # sparse reps, as a trained SPLADE's
    path = world["tmp"] / "dev.best"
    rr.trainer.save_checkpoint(path, model, None, rr)
    searcher = TorchSearcher.create("impact", impact_config(world["coll"], encoder=name, quantbits=16,
                                                            topterms=40000, checkpointfile=str(path) + ".params"))
    searcher.device = "cpu"
    searcher.index.create_index()
    docids = list(searcher.index.data.docid_strings[:10])
    rr.extractor.preprocess(["501", "502"], docids, {"501": TOPICS["501"], "502": TOPICS["502"]})
    topics = world["tmp"] / "t.tsv"
    topics.write_text(f"501\t{TOPICS['501']}\n502\t{TOPICS['502']}\n")
    served = load_run(searcher.query_from_file(topics, world["tmp"] / "o"))
    model.eval()
    for qid in ("501", "502"):
        batch = collate([rr.extractor.id2vec(qid, d, label=[1, 0], training=False) for d in docids], ARRAY_KEYS)
        with torch.no_grad():
            scores = rr.test(batch, torch.device("cpu")).numpy()
        for d, s in zip(docids, scores):
            assert served.get(qid, {}).get(d, 0.0) == pytest.approx(float(s), rel=SERVE_TOL, abs=SERVE_TOL), (qid, d)


@pytest.mark.parametrize("options", [{"quantbits": 0}, {"quantbits": 17}, {"encoder": "zzz"}, {"gelu": "relu"}])
def test_config_validation_matches_jax(world, options):
    with pytest.raises(JaxConfigError) as want:
        jax_searcher(world, **options)
    with pytest.raises(ConfigError) as got:
        TorchSearcher.create("impact", impact_config(world["coll"], **options))
    assert str(got.value) == str(want.value)


def test_checkpoint_head_mismatch_messages(world):
    """A checkpoint without the head, and one whose head has other
    submodules, raise the JAX searcher's messages."""
    from capreolus_tpu_torch.convert import load_params, save_params

    flat = load_params(port_searcher(world, "splade").config["checkpointfile"])
    no_head = {k: v for k, v in flat.items() if not k.startswith("params/mlm/")}
    old_head = dict(no_head, **{"params/mlm/kernel": np.zeros((64, 30522), np.float32)})
    for name, tree, match in (("nohead", no_head, r"lacks \['mlm'\]"),
                              ("oldhead", old_head, "predates the current head architecture")):
        path = save_params(tree, world["tmp"] / f"{name}.npz")
        searcher = port_searcher(world, "splade", checkpointfile=str(path))
        with pytest.raises(ValueError, match=match):
            searcher._encoder()
