"""Tests of the PyTorch port that need an NVIDIA GPU: each skips itself without
one. The file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

K1 is held against its plain version on the card at 2e-4 (the sigma=0.001
exact-match kernel amplifies f32 dot-product rounding); the GPU's first stage
must equal the CPU's, and the reranked scores agree within 2e-4.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu_torch
from capreolus_tpu_torch.core import constants
from capreolus_tpu_torch.ops import simmat
from capreolus_tpu_torch.reranker.common import KNRM_MUS, KNRM_SIGMAS

capreolus_tpu_torch.load_all_modules()
TOL = 2e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_args(b, q, d, e, seed, device):
    rng = np.random.Generator(np.random.PCG64(seed))
    emb = rng.standard_normal((500, e)).astype(np.float32)
    emb[0] = 0.0
    qt = rng.integers(1, 500, size=(b, q))
    qt[:, -1], qt[0, 0] = 0, -1
    dt = rng.integers(-2, 500, size=(b, d))
    for i, n in enumerate(rng.integers(d // 4, d + 1, size=b)):
        dt[i, n:] = 0
    return simmat.knrm_inputs(torch.from_numpy(emb).to(device), torch.from_numpy(qt).to(device),
                              torch.from_numpy(dt).to(device), KNRM_MUS, KNRM_SIGMAS)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 4, 37, 20), (100, 4, 800, 300), (7, 23, 129, 512)])
def test_k1_kernel_matches_plain(card, shape):
    args = _k1_args(*shape, seed=sum(shape), device=card)
    before = simmat.knrm_pool.launches
    got = simmat.knrm_pool(*args)
    torch.cuda.synchronize()
    assert simmat.knrm_pool.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), simmat.knrm_pool_plain(*args).cpu().numpy(), rtol=TOL, atol=TOL)
    # no atomics: the same inputs give the same bits
    np.testing.assert_array_equal(simmat.knrm_pool(*args).cpu().numpy(), got.cpu().numpy())


@pytest.mark.cuda
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(card):
    args = list(_k1_args(2, 4, 16, 8, seed=1, device=card))
    with pytest.raises(TypeError):
        simmat.knrm_pool(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        simmat.knrm_pool(args[0], args[1][:, :, :4], *args[2:])
    with pytest.raises(ValueError):
        simmat.knrm_pool(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2), *args[2:])
    with pytest.raises(ValueError):
        simmat.knrm_pool(args[0].cpu(), *args[1:])
    with pytest.raises(ValueError):  # E above the kernel's register tile
        simmat.knrm_pool(*_k1_args(2, 4, 16, 600, seed=2, device=card))


@pytest.mark.cuda
def test_reranking_service_on_the_card_matches_cpu(card, tmp_path, monkeypatch):
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService, RetrievalService

    monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / "cache")
    rng = np.random.Generator(np.random.PCG64(5))
    words = np.array([f"w{i}" for i in range(400)])
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    with open(corpus / "docs.trec", "wt", encoding="utf-8") as fh:
        for i in range(300):
            text = " ".join(rng.choice(words, size=int(rng.integers(50, 1000))))
            fh.write(f"<DOC>\n<DOCNO>C{i:04d}</DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n")
    coll = {"name": "dummy", "path": str(corpus)}
    cfg = {"gradkernels": False, "finetune": False,
           "extractor": {"embeddings": "random300", "maxqlen": 4, "maxdoclen": 800, "index": {"collection": coll}}}
    ckpt = save_params({"params/combine/kernel": rng.standard_normal((11, 1)).astype(np.float32),
                        "params/combine/bias": np.zeros(1, np.float32)}, tmp_path / "knrm.npz")
    index = Index.create("tpu", {"collection": coll})
    gpu_reranker = Reranker.create("KNRM", cfg)
    gpu = RerankingService(index, gpu_reranker, ckpt, topn=100, device=card)
    cpu_reranker = Reranker.create("KNRM", cfg)
    cpu_reranker.extractor.set_state(gpu_reranker.extractor.get_state())
    cpu = RerankingService(index, cpu_reranker, ckpt, topn=100, device="cpu")
    queries = ["w1 w7 w30", "w2 w250", "w399 w5 w6 w8"]

    assert RetrievalService.search_async(gpu, queries, k=100)() == RetrievalService.search_async(cpu, queries, k=100)()
    before = simmat.knrm_pool.launches
    gpu_hits = gpu.search(queries, k=20)
    assert simmat.knrm_pool.launches == before + len(queries)
    for g, c in zip(gpu_hits, cpu.search(queries, k=20)):
        assert len(g) == len(c) == 20
        np.testing.assert_allclose([s for _, s in g], [s for _, s in c], rtol=TOL, atol=TOL)
