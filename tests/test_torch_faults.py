"""The port's repairs of three faults, against the JAX package on the CPU:

- ``HybridRetrievalService`` composes legs that expose only ``search`` (JAX
  searches such a leg at dispatch); the port required ``search_async``.
- A ``trainer.ckpt=sharded`` directory, as JAX's ``save_sharded`` writes it,
  loads through ``convert.load_params`` and serves as a searcher's
  ``checkpointfile``; the port called ``np.load`` on the directory.
- One TF32 policy for every f32 path on the card: ``reranker.common.matmul_f32``
  clears ``torch.backends.cuda.matmul.allow_tf32`` for the rerank stage, the
  searchers' and services' encoders and the trainer's steps and predictions,
  whatever the process set; only the dense searcher refused it before. Here
  the flag each path runs under is recorded (the card's arithmetic is held
  in ``tests/test_torch_tf32.py``).

Tolerances: the hybrid's fused lists equal JAX's (both legs are fixed hit
lists, so fusion is the same arithmetic: 1e-12); a sharded checkpoint's
leaves equal the tree JAX wrote exactly (bf16 leaves widened to f32 exactly),
and a searcher reading the directory gives the embeddings of the same
weights from an ``.npz`` bit for bit.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

import capreolus_tpu.serving as jax_serving  # noqa: E402
import capreolus_tpu_torch.serving as port_serving  # noqa: E402
from capreolus_tpu.searcher import Searcher as JaxSearcher  # noqa: E402
from capreolus_tpu.utils.sharded_ckpt import restore_params as jax_restore_params  # noqa: E402
from capreolus_tpu.utils.sharded_ckpt import save_sharded  # noqa: E402
from capreolus_tpu_torch.convert import flatten_tree, load_params, save_params  # noqa: E402
from capreolus_tpu_torch.reranker.common import cudnn_f32, matmul_f32  # noqa: E402
from capreolus_tpu_torch.searcher import Searcher as TorchSearcher  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from torch_dense_util import jax_dense_checkpoint, searcher_config, write_dense_corpus  # noqa: E402


# ---------------------------------------------------------------- hybrid legs
class SearchOnly:
    """A leg with only the ``search(queries, k)`` contract."""

    def __init__(self, lists):
        self.lists = lists
        self.calls = []

    def search(self, queries, k=10):
        self.calls.append((tuple(queries), k))
        return [self.lists[q][:k] for q in queries]


LISTS_A = {"q1": [("d1", 3.0), ("d2", 2.0), ("d3", 1.0)], "q2": [("d4", 0.5)]}
LISTS_B = {"q1": [("d2", 0.9), ("d3", 0.8), ("d5", 0.1)], "q2": [("d4", 0.7), ("d1", 0.2)]}


@pytest.mark.parametrize("method", ["rrf", "interp"])
def test_hybrid_searches_legs_without_search_async_as_jax_does(method):
    legs = (SearchOnly(LISTS_A), SearchOnly(LISTS_B))
    got = port_serving.HybridRetrievalService(*legs, method=method, depth=3).search(["q1", "q2"], k=3)
    want = jax_serving.HybridRetrievalService(SearchOnly(LISTS_A), SearchOnly(LISTS_B), method=method,
                                              depth=3).search(["q1", "q2"], k=3)
    assert [[d for d, _ in h] for h in got] == [[d for d, _ in h] for h in want]
    for a, b in zip(got, want):
        assert all(abs(x - y) <= 1e-12 for (_, x), (_, y) in zip(a, b))
    assert legs[0].calls == [(("q1", "q2"), 3)]
    # the collector dispatches at once, as JAX's: a search-only leg is searched before collect
    svc = port_serving.HybridRetrievalService(SearchOnly(LISTS_A), SearchOnly(LISTS_B), method=method, depth=3)
    collect = svc.search_async(["q1"], k=2)
    assert svc.services[0].calls and svc.services[1].calls
    assert collect() == svc.search(["q1"], k=2)


def test_hybrid_mixes_an_async_leg_with_a_search_only_leg(torch_cache):
    sparse = port_serving.RetrievalService.from_config(collection="dummy", device="cpu")
    fixed = SearchOnly({q: [("D001", 1.0)] for q in ("galaxies collide", "whales")})
    hybrid = port_serving.HybridRetrievalService(sparse, fixed, depth=3)
    assert hybrid.batch_size == 64 and hybrid._docids == sparse._docids
    fused = hybrid.search(["galaxies collide", "whales"], k=3)
    assert fused[0][0][0] in ("D001", "D003") and len(fused) == 2


# ---------------------------------------------------------------- sharded checkpoints
def test_sharded_directory_loads_through_load_params(tmp_path):
    rng = np.random.Generator(np.random.PCG64(5))
    tree = {"params": {"bert": {"layer_0": {"kernel": rng.standard_normal((4, 6)).astype(np.float32),
                                            "bias": rng.standard_normal(6).astype(np.float32)}},
                       "linear": {"kernel": jnp.asarray(rng.standard_normal((6, 3)), dtype=jnp.bfloat16)}}}
    save_sharded(tmp_path / "ckpt", tree)
    got = load_params(tmp_path / "ckpt")
    want = flatten_tree(jax_restore_params(tmp_path / "ckpt"))  # JAX's reader: the manifest's order
    assert list(got) == list(want) and sorted(want) == sorted(flatten_tree(tree))
    for key, value in want.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], np.asarray(value, dtype=np.float32))
    # a tree saved without the "params" level gets it, as JAX's searchers read it
    save_sharded(tmp_path / "bare", tree["params"])
    assert list(load_params(tmp_path / "bare")) == list(want)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        load_params(tmp_path / "empty")


def test_searcher_reads_a_sharded_checkpointfile(tmpdir_as_cache, torch_cache):
    coll = write_dense_corpus(tmpdir_as_cache / "corpus")
    jax_searcher = JaxSearcher.create("dense", searcher_config(coll))
    npz = jax_dense_checkpoint(jax_searcher, tmpdir_as_cache / "dense.npz")
    flat = load_params(npz)
    tree = {}
    for key, value in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    save_sharded(tmpdir_as_cache / "sharded", tree)
    embs = {}
    for name, ckpt in (("npz", npz), ("sharded", str(tmpdir_as_cache / "sharded"))):
        searcher = TorchSearcher.create("dense", searcher_config(coll, checkpointfile=ckpt))
        searcher.device = "cpu"
        embs[name] = searcher.embed_queries(["galaxy telescope orbit", "whale ocean"]).numpy()
    np.testing.assert_array_equal(embs["sharded"], embs["npz"])


# ---------------------------------------------------------------- TF32
@pytest.fixture
def tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def test_matmul_f32_is_counted_across_nesting_and_threads(tf32_on):
    flags = torch.backends.cuda.matmul
    with matmul_f32():
        assert flags.allow_tf32 is False
        with matmul_f32():
            assert flags.allow_tf32 is False
        assert flags.allow_tf32 is False  # the inner exit does not restore while the outer is inside
    assert flags.allow_tf32 is True
    inside, release = threading.Event(), threading.Event()

    def hold():
        with matmul_f32():
            inside.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    inside.wait(10)
    with matmul_f32():
        pass
    assert flags.allow_tf32 is False  # the other thread is still inside
    release.set()
    t.join()
    assert flags.allow_tf32 is True
    with cudnn_f32():  # the two scopes hold their own flags
        assert torch.backends.cudnn.allow_tf32 is False and flags.allow_tf32 is True

    @matmul_f32()
    def decorated():
        return flags.allow_tf32

    assert decorated() is False and flags.allow_tf32 is True


def spy(monkeypatch, obj, name, seen):
    original = getattr(obj, name)

    def wrapper(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return original(*args, **kwargs)

    monkeypatch.setattr(obj, name, wrapper)


def test_rerank_stage_and_trainer_run_without_tf32(tf32_on, torch_cache, monkeypatch, tmp_path):
    from chip_smoke import seeded_bert_params
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    ckpt = save_params(seeded_bert_params(get_bert_config("tiny"), seed=4, std=0.05), tmp_path / "bert.npz")
    reranker = Reranker.create("BERTMaxP", {"pretrained": "tiny", "trainer": {"batch": 2}})
    svc = port_serving.RerankingService(Index.create("tpu", {"collection": {"name": "dummy"}}), reranker,
                                        str(ckpt), topn=3, device="cpu")
    seen = []
    spy(monkeypatch, reranker, "test", seen)
    assert svc.search(["galaxies collide"], k=2)[0]
    assert seen == [False] and torch.backends.cuda.matmul.allow_tf32 is True

    trainer = reranker.trainer
    trainer.device = "cpu"
    model = reranker.model
    svc.rerank_batch("q", "galaxies collide", ["D001"])  # the live query's tokens
    seen.clear()
    spy(monkeypatch, trainer, "compute_loss", seen)
    samples = [reranker.extractor.id2vec("q", d, negid=n, label=[1, 0]) for d, n in (("D001", "D002"), ("D003", "D002"))]
    micro = collate(samples, ARRAY_KEYS)
    batches = {k: np.asarray(v)[None] for k, v in micro.items()}
    optimizer = trainer.make_optimizer(reranker, model)
    trainer.train_step(reranker, model, optimizer, batches, 0, trainer.step_seed(0, 0))
    assert seen == [False] and torch.backends.cuda.matmul.allow_tf32 is True


@pytest.mark.parametrize("family", ["dense", "colbert", "impact"])
def test_searcher_encoders_run_without_tf32(tf32_on, tmpdir_as_cache, torch_cache, monkeypatch, family):
    coll = write_dense_corpus(tmpdir_as_cache / "corpus")
    options = {"dim": 8} if family == "colbert" else {}
    searcher = TorchSearcher.create(family, searcher_config(coll, allowrandominit=True, **options))
    searcher.device = "cpu"
    model = searcher._encoder()
    seen = []
    spy(monkeypatch, model, "forward" if family == "dense" else
        {"colbert": "encode_query", "impact": "weights"}[family], seen)
    if family == "dense":
        searcher.embed_queries(["galaxy telescope"])
    elif family == "colbert":
        searcher.encode_queries(searcher._tokenize(["galaxy telescope"], 8))
    else:
        searcher.query_weights_batch(["galaxy telescope"])
    assert seen == [False] and torch.backends.cuda.matmul.allow_tf32 is True
