"""Tests of the PyTorch port that need an NVIDIA GPU: each skips itself without
one. The file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

K1 is held against its plain version on the card at 2e-4 (the sigma=0.001
exact-match kernel amplifies f32 dot-product rounding); the GPU's first stage
must equal the CPU's, and the reranked scores agree within 2e-4. K2 is held
against its plain version at 1e-4 with f32 inputs (one softmax, f32 sums in
another order) and 2e-2 with bf16 inputs (outputs rounded to bf16); tiny
BERTMaxP served on the card agrees with the CPU within 1e-4. K3 is held
against its plain version at 1e-4 (relative and absolute; equal bf16 inputs,
exact f32 products, the sums in another order), with invalid docs at -inf in
both; ColBERT served on the card agrees with the CPU within 1e-2, the JAX
suite's tolerance for bf16 MaxSim sums (embeddings that differ by f32 rounding
can round to neighbouring bf16 values).
"""

import numpy as np
import pytest
import torch

import capreolus_tpu_torch
from capreolus_tpu_torch.core import constants
from capreolus_tpu_torch.ops import flash_attention as fa
from capreolus_tpu_torch.ops import maxsim as ms
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
    coll = _write_corpus(tmp_path / "corpus", rng)
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


def _write_corpus(directory, rng, num_docs=300, min_len=50, max_len=1000):
    words = np.array([f"w{i}" for i in range(400)])
    directory.mkdir()
    with open(directory / "docs.trec", "wt", encoding="utf-8") as fh:
        for i in range(num_docs):
            text = " ".join(rng.choice(words, size=int(rng.integers(min_len, max_len))))
            fh.write(f"<DOC>\n<DOCNO>C{i:04d}</DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n")
    return {"name": "dummy", "path": str(directory)}


def _k2_args(shape, dtype, seed, device):
    """q, k, v [B, H, L, D] and a [B, L] bool key mask: ragged key counts, a
    hole, and the last batch element with every key masked."""
    b, h, l, d = shape
    rng = np.random.Generator(np.random.PCG64(seed))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype) for _ in range(3))
    mask = np.zeros((b, l), dtype=bool)
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        mask[i, :n] = True
    mask[0, l // 3] = False
    mask[-1] = False
    return q, k, v, torch.from_numpy(mask).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,tol", [
    (torch.float32, (3, 2, 77, 32), 1e-4), (torch.float32, (4, 12, 256, 64), 1e-4),
    (torch.float32, (2, 2, 300, 128), 1e-4), (torch.float32, (2, 3, 1, 64), 1e-4),
    (torch.bfloat16, (3, 2, 77, 32), 2e-2), (torch.bfloat16, (4, 12, 256, 64), 2e-2),
])
def test_k2_kernel_matches_plain(card, dtype, shape, tol):
    q, k, v, mask = _k2_args(shape, dtype, seed=sum(shape), device=card)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.dtype == dtype
    want = fa.attention_plain(q, k, v, mask)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol)
    # the fully masked batch element gets the mean of V
    mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(v[-1])
    np.testing.assert_allclose(got[-1].float().cpu().numpy(), mean_v.cpu().numpy(), rtol=tol, atol=tol)
    # no atomics: the same inputs give the same bits; an integer mask means the same
    torch.testing.assert_close(fa.flash_attention(q, k, v, mask), got, rtol=0, atol=0)
    torch.testing.assert_close(fa.flash_attention(q, k, v, mask.to(torch.int64)), got, rtol=0, atol=0)
    torch.testing.assert_close(fa.multihead_attention(q, k, v, mask), got, rtol=0, atol=0)


@pytest.mark.cuda
def test_k2_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, k, v, mask = _k2_args((2, 2, 40, 64), torch.float32, seed=4, device=card)
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double(), mask)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v, mask)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k, v, mask.float())
    with pytest.raises(ValueError):  # head dim outside {32, 64, 128}
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous(), mask)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :39].contiguous(), v, mask)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, mask.cpu())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, mask[:, :39].contiguous())
    offset = torch.empty(q.numel() + 1, device=card)[1:].view(q.shape)
    with pytest.raises(ValueError):
        fa.flash_attention(offset, k, v, mask)


def seeded_bert_params(model, seed, std):
    """Flat ``params/...`` arrays of a ``_BertScorer``'s geometry, as the JAX
    trainer names them: N(0, std) matrices and embeddings, zero biases, unit
    LayerNorm scales."""
    rng = np.random.Generator(np.random.PCG64(seed))
    flat = {}
    for name, tensor in model.state_dict().items():
        *path, leaf = name.split(".")
        module = model.get_submodule(".".join(path))
        if isinstance(module, torch.nn.LayerNorm):
            value = np.ones(tuple(tensor.shape), np.float32) if leaf == "weight" else np.zeros(tuple(tensor.shape), np.float32)
            leaf = "scale" if leaf == "weight" else leaf
        elif leaf == "bias":
            value = np.zeros(tuple(tensor.shape), np.float32)
        else:
            value = (rng.standard_normal(tuple(tensor.shape)) * std).astype(np.float32)
            if isinstance(module, torch.nn.Linear):
                leaf, value = "kernel", value.T
        flat["/".join(["params", *path, leaf])] = value
    return flat


@pytest.mark.cuda
def test_bert_reranking_service_on_the_card_matches_cpu(card, tmp_path, monkeypatch):
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService

    monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / "cache")
    coll = _write_corpus(tmp_path / "corpus", np.random.Generator(np.random.PCG64(6)))
    cfg = {"pretrained": "tiny", "extractor": {"maxseqlen": 128, "maxqlen": 8, "numpassages": 4,
                                               "passagelen": 100, "stride": 80, "index": {"collection": coll}}}
    gpu_reranker = Reranker.create("BERTMaxP", cfg)
    # std 0.2: at the tiny width, BERT's usual 0.02 leaves every doc within 1e-5 of the others
    ckpt = save_params(seeded_bert_params(gpu_reranker.build_model(), seed=8, std=0.2), tmp_path / "bert.npz")
    index = Index.create("tpu", {"collection": coll})
    gpu = RerankingService(index, gpu_reranker, ckpt, topn=50, device=card)
    cpu = RerankingService(index, Reranker.create("BERTMaxP", cfg), ckpt, topn=50, device="cpu")
    queries = ["w1 w7 w30", "w2 w250", "w399 w5 w6 w8"]

    before = fa.flash_attention.launches
    gpu_hits = gpu.search(queries, k=20)
    assert fa.flash_attention.launches == before + 2 * len(queries)  # tiny: 2 layers, one batch per query
    for g, c in zip(gpu_hits, cpu.search(queries, k=20)):
        assert len(g) == len(c) == 20
        np.testing.assert_allclose([s for _, s in g], [s for _, s in c], rtol=1e-4, atol=1e-4)


def _k3_args(n_q, lq, ld, c, dim, seed, device):
    """K3's arguments: L2-normalised q [Q, Lq, dim] f32 and docs_t [Ld, C, dim]
    bf16, ragged doc lengths with holes, docs 0 and C // 2 fully masked."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def unit(*shape):
        x = rng.standard_normal(shape)
        return torch.from_numpy((x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32))

    mask = np.arange(ld)[:, None] < rng.integers(1, ld + 1, size=c)[None, :]  # [Ld, C]
    mask &= rng.random((ld, c)) > 0.1
    mask[0] |= rng.random(c) > 0.5
    mask[:, [0, c // 2]] = False
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    return (unit(n_q, lq, dim).to(device), unit(ld, c, dim).to(device, torch.bfloat16),
            torch.from_numpy(bias).to(device), torch.from_numpy(mask.any(axis=0)).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 32, 180, 1000, 128),  # a served query over docs of Ld 180; C off every tile
    (5, 32, 23, 203, 128),    # 160 query rows: the 128-row blocks
    (64, 32, 20, 300, 128),   # a served batch of 64 queries
    (5, 7, 13, 131, 24), (1, 3, 5, 7, 8), (5, 1, 4, 65, 8),
    (3, 5, 7, 11, 20),        # dim off 8: scalar loads
    (2, 150, 9, 70, 24),      # more query tokens than a block's rows: row chunks
])
def test_k3_kernel_matches_plain(card, shape):
    q, docs_t, bias_t, valid = _k3_args(*shape, seed=sum(shape), device=card)
    before = ms.maxsim.launches
    got = ms.maxsim(q, docs_t, bias_t, valid)
    torch.cuda.synchronize()
    assert ms.maxsim.launches == before + 1 and got.shape == (shape[0], shape[3])
    want = ms.maxsim_scores_plain(q, docs_t, bias_t, valid).cpu().numpy()
    out = got.cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(out), np.isneginf(want))
    assert np.isneginf(out[:, [0, shape[3] // 2]]).all()
    finite = np.isfinite(want)
    np.testing.assert_allclose(out[finite], want[finite], rtol=1e-4, atol=1e-4)
    # no atomics: the same inputs give the same bits, through every entry point
    torch.testing.assert_close(ms.maxsim(q, docs_t, bias_t, valid), got, rtol=0, atol=0)
    torch.testing.assert_close(ms.maxsim(q.bfloat16(), docs_t, bias_t, valid), got, rtol=0, atol=0)
    torch.testing.assert_close(ms.maxsim_scores(q, docs_t, bias_t, valid), got, rtol=0, atol=0)


@pytest.mark.cuda
def test_k3_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, docs_t, bias_t, valid = _k3_args(2, 4, 6, 40, 16, seed=3, device=card)
    with pytest.raises(TypeError):
        ms.maxsim(q.double(), docs_t, bias_t, valid)
    with pytest.raises(TypeError):
        ms.maxsim(q, docs_t.float(), bias_t, valid)
    with pytest.raises(TypeError):
        ms.maxsim(q, docs_t, bias_t.double(), valid)
    with pytest.raises(TypeError):
        ms.maxsim(q, docs_t, bias_t, valid.to(torch.uint8))
    with pytest.raises(ValueError):
        ms.maxsim(q, docs_t.cpu(), bias_t, valid)
    with pytest.raises(ValueError):
        ms.maxsim(q, docs_t, bias_t[:, :39].contiguous(), valid)
    with pytest.raises(ValueError):
        ms.maxsim(q[..., :8].contiguous(), docs_t, bias_t, valid)
    with pytest.raises(ValueError):
        ms.maxsim(q[0], docs_t, bias_t, valid)
    with pytest.raises(ValueError):  # dim above the kernel's 128
        wide = _k3_args(1, 2, 3, 5, 136, seed=4, device=card)
        ms.maxsim(*wide)
    with pytest.raises(ValueError):
        ms.maxsim(q, docs_t.transpose(0, 1).contiguous().transpose(0, 1), bias_t, valid)
    offset = torch.empty(docs_t.numel() + 1, dtype=torch.bfloat16, device=card)[1:].view(docs_t.shape)
    offset.copy_(docs_t)
    with pytest.raises(ValueError):
        ms.maxsim(q, offset, bias_t, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("collection", ["dummy", "corpus"])
def test_colbert_service_on_the_card_matches_cpu(card, tmp_path, monkeypatch, collection):
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    if collection == "dummy":
        coll = {"collection": "dummy"}
        queries = ["galaxies collide", "whales in the ocean", "telescope orbit", "distant stars", "sea"]
    else:
        path = _write_corpus(tmp_path / "corpus", np.random.Generator(np.random.PCG64(7)), min_len=20, max_len=300)
        coll = {"collection": "dummy", "collection_path": path["path"]}
        queries = ["w1 w7 w30", "w2 w250", "w399 w5 w6 w8", "w11", "w3 w4"]
    config = {"allowrandominit": True, "dim": 8, "maxdoclen": 32, "maxqlen": 8, "batch": 4, "max_k": 20}
    services = {}
    for name, device in (("gpu", card), ("cpu", "cpu")):  # separate caches: each device encodes the corpus
        monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / f"cache_{name}")
        services[name] = ColbertRetrievalService.from_config(device=device, **coll, **config)
    before, before_k2 = ms.maxsim.launches, fa.flash_attention.launches
    gpu_hits = services["gpu"].search(queries, k=20)
    assert ms.maxsim.launches == before + 2  # two query batches of at most 4
    assert fa.flash_attention.launches == before_k2 + 2 * 2  # tiny: 2 layers per query batch
    for g, c in zip(gpu_hits, services["cpu"].search(queries, k=20)):
        assert len(g) == len(c) > 0
        for (gd, gs), (cd, cs) in zip(g, c):
            assert abs(gs - cs) <= 1e-2
            assert gd == cd or abs(gs - cs) <= 1e-2  # a different doc only at a near-tie
        cpu_scores = dict(c)
        assert all(abs(cpu_scores[d] - s) <= 1e-2 for d, s in g if d in cpu_scores)
