"""Tests of the PyTorch port that need an NVIDIA GPU: each skips itself without
one. The file imports neither JAX nor the JAX package, so that on a machine
with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

K1 is held against its plain version on the card at 2e-4 (the sigma=0.001
exact-match kernel amplifies f32 dot-product rounding); the GPU's first stage
must equal the CPU's, and the reranked scores agree within 2e-4. K2 is held
against its plain version at 1e-4 with f32 inputs (one softmax, f32 sums in
another order, split-TF32 products that keep f32 accuracy) and 2e-2 with bf16
inputs (probabilities and outputs rounded to bf16), on contiguous inputs and
on the encoder's strided head views, which give the same bits; tiny
BERTMaxP served on the card agrees with the CPU within 1e-4. K3 is held
against its plain version at 1e-4 (relative and absolute; equal bf16 inputs,
exact f32 products, the sums in another order), with invalid docs at -inf in
both; ColBERT served on the card agrees with the CPU within 1e-2, the JAX
suite's tolerance for bf16 MaxSim sums (embeddings that differ by f32 rounding
can round to neighbouring bf16 values). X1 equals its plain version and int64
products exactly in its int32 epilogue, at both tile widths, at ragged shapes
and through its zero-padded copies; its f32 epilogue is bit-identical to its
plain version; its int8-gelu codes are within one step of the plain version's
at a share of at most 1e-4 (the kernel's tanhf or erff and torch's can round
apart at a code boundary); Q1 equals its plain version exactly. Tiny BERTMaxP with ``quantize=int8`` served on the card is
held against the CPU with the card's weights and calibrated stats layer by
layer, each layer from the card's input to it: an int8 layer is a step
function of its input, so a code on a rounding boundary can flip by one step
between the devices. A layer's outputs agree within 1e-1, and at most 5% of
them differ by more than 1e-4: where the input of a tiny layer moves by 1e-7
on the CPU, its outputs move by up to 5.3e-2, 1.1% of them by more than 1e-4
(six seeds, ``tests/test_torch_int8.py``), while a wiring fault moves nearly
every output by about 1. The head from the card's last hidden states agrees
within 1e-4, as do the served scores. ColBERT over int8 / int4 corpora agrees
within 1e-2. Rankings agree docid by docid but for near-ties: two docs that
trade places score within the tolerance of each other in both lists. The
sparse engine's tiered path on the card gives the CPU's ordinals and scores
within 1e-6 of the row's top score (f32 formulas an ulp apart), and the exact
path's within 1e-5 (a tree sum against a sequential sum); pruned, streamed
and bit-packed results on the card equal the card's exhaustive tiered bits.
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
INT8_LAYER_TOL = 1e-1  # a tiny int8 BERT layer, card vs CPU from the same input: max |err|
INT8_LAYER_MOVED_SHARE = 5e-2  # and the share of its outputs that differ by more than 1e-4


def assert_same_ranking(a_hits, b_hits, tol, what=""):
    """Two (docid, score) rankings of one query agree: the same length, the
    scores at each rank within ``tol``, every doc in both lists within ``tol``
    of itself, and the same docid at each rank but for near-ties: where the
    lists hold different docs at a rank, the two docs score within ``tol`` of
    each other in each list (a doc missing from the other list, past its cut,
    takes its own score there)."""
    assert len(a_hits) == len(b_hits), (what, a_hits, b_hits)
    a_of, b_of = dict(a_hits), dict(b_hits)
    for d in a_of.keys() & b_of.keys():
        assert abs(a_of[d] - b_of[d]) <= tol, (what, d, a_of[d], b_of[d])
    for rank, ((da, sa), (db, sb)) in enumerate(zip(a_hits, b_hits)):
        assert abs(sa - sb) <= tol, (what, rank, a_hits, b_hits)
        if da != db:
            assert abs(b_of.get(da, sa) - sb) <= tol and abs(a_of.get(db, sb) - sa) <= tol, \
                (what, f"rank {rank}: {da} and {db} are not a near-tie", a_hits, b_hits)


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
@pytest.mark.parametrize("shape", [(5, 4, 803, 300), (9, 3, 130, 20), (2, 4, 7, 33)])
def test_k1_kernel_with_an_all_pad_element_and_d_off_the_split(card, shape):
    """Batch element 1 is all pad; D is no multiple of the rows a block takes;
    E = 33 takes the scalar loads. Each call's blocks take tickets of their
    own, so calls on two streams at once give the same bits."""
    args = _k1_args(*shape, seed=sum(shape), device=card)
    args[1][1] = 0.0
    args[3][1] = 0
    got = simmat.knrm_pool(*args)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), simmat.knrm_pool_plain(*args).cpu().numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(simmat.knrm_pool(*args).cpu().numpy(), got.cpu().numpy())
    side = torch.cuda.Stream(device=got.device)
    side.wait_stream(torch.cuda.current_stream(got.device))
    with torch.cuda.stream(side):
        beside = [simmat.knrm_pool(*args) for _ in range(4)]
    here = [simmat.knrm_pool(*args) for _ in range(4)]
    torch.cuda.synchronize()
    for out in beside + here:
        np.testing.assert_array_equal(out.cpu().numpy(), got.cpu().numpy())


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


def _k2_args(shape, dtype, seed, device, layout="contiguous"):
    """q, k, v [B, H, L, D] and a [B, L] bool key mask: ragged key counts, a
    hole, and the last batch element with every key masked. ``layout="heads"``
    gives q, k, v as the encoder hands them over: [B, H, L, D] views of
    [B, L, H * D] rows."""
    b, h, l, d = shape
    rng = np.random.Generator(np.random.PCG64(seed))
    if layout == "heads":
        q, k, v = (torch.from_numpy(rng.standard_normal((b, l, h * d)).astype(np.float32)).to(device, dtype)
                   .view(b, l, h, d).transpose(1, 2) for _ in range(3))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device, dtype) for _ in range(3))
    mask = np.zeros((b, l), dtype=bool)
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        mask[i, :n] = True
    mask[0, l // 3] = False
    mask[-1] = False
    return q, k, v, torch.from_numpy(mask).to(device)


K2_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
K2_CASES = [  # contiguous [B, H, L, D]
    (torch.float32, (3, 2, 77, 32), "contiguous"), (torch.float32, (4, 12, 256, 64), "contiguous"),
    (torch.float32, (2, 2, 300, 128), "contiguous"), (torch.float32, (2, 3, 1, 64), "contiguous"),
    (torch.bfloat16, (3, 2, 77, 32), "contiguous"), (torch.bfloat16, (4, 12, 256, 64), "contiguous"),
] + [  # the encoder's head views, at every L it serves or tests, every head dim, both dtypes
    (dtype, (3, 2, l, d), "heads") for dtype in (torch.float32, torch.bfloat16)
    for l in (1, 32, 77, 180, 256) for d in (32, 64, 128)
] + [(torch.float32, (4, 12, 256, 64), "heads"), (torch.bfloat16, (4, 12, 256, 64), "heads")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,layout", K2_CASES)
def test_k2_kernel_matches_plain(card, dtype, shape, layout):
    tol = K2_TOL[dtype]
    q, k, v, mask = _k2_args(shape, dtype, seed=sum(shape), device=card, layout=layout)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.dtype == dtype and got.shape == shape
    # written [B, L, H, D]: merging the heads is a view
    assert got.transpose(1, 2).is_contiguous()
    want = fa.attention_plain(q, k, v, mask)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), rtol=tol, atol=tol)
    # the fully masked batch element gets the mean of V
    mean_v = v[-1].float().mean(dim=1, keepdim=True).expand_as(v[-1])
    np.testing.assert_allclose(got[-1].float().cpu().numpy(), mean_v.cpu().numpy(), rtol=tol, atol=tol)
    # no atomics: the same inputs give the same bits; an integer mask means the same
    torch.testing.assert_close(fa.flash_attention(q, k, v, mask), got, rtol=0, atol=0)
    torch.testing.assert_close(fa.flash_attention(q, k, v, mask.to(torch.int64)), got, rtol=0, atol=0)
    torch.testing.assert_close(fa.multihead_attention(q, k, v, mask), got, rtol=0, atol=0)
    if layout == "heads":  # the strides change where values are read, not the arithmetic
        contiguous = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
        torch.testing.assert_close(contiguous, got, rtol=0, atol=0)


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
        fa.flash_attention(q, k, v, mask.cpu())
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, mask[:, :39].contiguous())
    offset = torch.empty(q.numel() + 1, device=card)[1:].view(q.shape)
    with pytest.raises(ValueError):
        fa.flash_attention(offset, k, v, mask)
    # a strided view is taken: the same bits as its contiguous copy
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    torch.testing.assert_close(fa.flash_attention(strided, k, v, mask), fa.flash_attention(q, k, v, mask),
                               rtol=0, atol=0)
    # but not a last dimension of stride != 1, nor a row stride off 16 bytes
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention(torch.randn(2, 2, 40, 128, device=card)[..., ::2], k, v, mask)
    odd = torch.randn(2 * 2 * 40 * 65, device=card).as_strided((2, 2, 40, 64), (2 * 40 * 65, 40 * 65, 65, 1))
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention(odd, k, v, mask)


@pytest.mark.cuda
def test_int8_scales_on_the_card_equal_the_cpus(card):
    """The weight, GELU and ColBERT query scales divide by a tensor of 127s on
    both devices, so the card's scales are the CPU's bit for bit (torch on
    CUDA would multiply by the reciprocal of a Python 127.0)."""
    import dataclasses

    from capreolus_tpu_torch.ops import quantization as pq
    from capreolus_tpu_torch.reranker.bert.encoder import BertConfig, BertLayer, Int8Linear

    rng = np.random.Generator(np.random.PCG64(12))
    linear = Int8Linear(768, 768)
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy((rng.standard_normal((768, 768)) * 0.02).astype(np.float32)))
    fold = torch.from_numpy((rng.random(768) * 0.1 + 0.01).astype(np.float32))
    gpu_linear = Int8Linear(768, 768).to(card)
    gpu_linear.load_state_dict(linear.state_dict())
    for f in (None, fold):
        linear.quantize_weight(fold_scales=f)
        gpu_linear.quantize_weight(fold_scales=None if f is None else f.to(card))
        assert torch.equal(gpu_linear.weight_scale.cpu(), linear.weight_scale)
        assert torch.equal(gpu_linear.weight_q.cpu(), linear.weight_q)

    config = dataclasses.replace(BertConfig(), num_layers=1, quantize="int8")
    amax = torch.from_numpy(rng.random(config.intermediate_size).astype(np.float32) * 10)
    amax[::7] = 0.0
    layer = BertLayer(config)
    layer.gelu_amax = amax
    gpu_layer = BertLayer(config).to(card)
    gpu_layer.gelu_amax = amax.to(card)
    assert torch.equal(gpu_layer.gelu_scales().cpu(), layer.gelu_scales())

    queries = torch.from_numpy(rng.standard_normal((64, 32, 128)).astype(np.float32))
    codes, scales = pq.quantize_rows_torch(queries)
    gpu_codes, gpu_scales = pq.quantize_rows_torch(queries.to(card))
    assert torch.equal(gpu_scales.cpu(), scales) and torch.equal(gpu_codes.cpu(), codes)
    assert torch.equal(scales, (queries.abs().amax(dim=(1, 2)).double() / 127).float())


def seeded_bert_params(model, seed, std):
    """Flat ``params/...`` arrays of a ``_BertScorer``'s geometry, as the JAX
    trainer names them: N(0, std) matrices and embeddings, zero biases, unit
    LayerNorm scales."""
    rng = np.random.Generator(np.random.PCG64(seed))
    flat = {}
    for name, tensor in model.named_parameters():  # an int8 model's gelu_amax buffers are not params
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
    bf16, ragged doc lengths with holes, docs 0 and C // 2 fully masked, and
    doc 1 (when C > 2) valid at its last token only."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def unit(*shape):
        x = rng.standard_normal(shape)
        return torch.from_numpy((x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32))

    mask = np.arange(ld)[:, None] < rng.integers(1, ld + 1, size=c)[None, :]  # [Ld, C]
    mask &= rng.random((ld, c)) > 0.1
    mask[0] |= rng.random(c) > 0.5
    mask[:, [0, c // 2]] = False
    if c > 2:
        mask[:, 1] = False
        mask[ld - 1, 1] = True
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
    (63, 1, 9, 70, 128),      # 63 query rows
    (1, 64, 9, 70, 128),      # 64 rows: one full warpgroup tile
    (5, 13, 9, 70, 128),      # 65 rows: two warpgroup tiles
    (64, 32, 13, 130, 128),   # 2048 rows: 11 groups of three warpgroups; C off the doc tile, Ld off the split
    (3, 33, 17, 129, 64),     # Lq = 33: one query per warpgroup
    (2, 65, 7, 65, 24),       # Lq = 65: two 64-row chunks in one pass
    (1, 200, 5, 33, 20),      # Lq = 200: four chunks in two passes, dim off 8
    (2, 32, 11, 200, 20),     # dim off 8 across Ld splits
    (1, 32, 181, 1000, 24),   # Ld off the split; dim 24 by TMA, zero-filled past dim
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


def _x1_args(m, n, k, seed, device):
    """a [M, K] and w [N, K] int8 over the full range, with -128 and 127 in
    row 0 of each, so that the extreme products are exercised."""
    rng = np.random.Generator(np.random.PCG64(seed))
    a = rng.integers(-128, 128, size=(m, k), dtype=np.int8)
    w = rng.integers(-128, 128, size=(n, k), dtype=np.int8)
    a[0, ::2], w[0, ::2] = -128, -128
    a[0, 1::2], w[0, 1::2] = 127, -128
    return torch.from_numpy(a).to(device), torch.from_numpy(w).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 1, 1), (37, 29, 45), (130, 257, 64), (5, 7, 300), (64, 64, 4112),
    (300, 3072, 768),   # a slice of the served up-projection
    (257, 768, 3072),   # the served down-projection, M off the tile
    (32, 46080, 128),   # the ColBERT product of one query against 256 docs of 180 tokens
])
def test_x1_kernel_matches_plain_exactly(card, shape):
    from capreolus_tpu_torch.ops import int8_matmul as im

    a, w = _x1_args(*shape, seed=sum(shape), device=card)
    before = im.int8_matmul.launches
    got = im.int8_matmul(a, w)
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 1 and got.dtype == torch.int32 and got.shape == shape[:2]
    want = a.cpu().to(torch.int64) @ w.cpu().to(torch.int64).T
    assert torch.equal(got.cpu().to(torch.int64), want)
    assert torch.equal(im.int8_matmul_plain(a, w), got)
    assert torch.equal(im.int8_mm(a, w), got)


@pytest.mark.cuda
def test_x1_kernel_takes_misaligned_operands(card):
    from capreolus_tpu_torch.ops import int8_matmul as im

    a, w = _x1_args(70, 40, 96, seed=5, device=card)
    offset = torch.empty(a.numel() + 1, dtype=torch.int8, device=card)[1:].view(a.shape)
    offset.copy_(a)
    assert torch.equal(im.int8_matmul(offset, w), im.int8_matmul_plain(a, w))


@pytest.mark.cuda
def test_x1_wrapper_rejects_what_the_kernel_does_not_take(card):
    from capreolus_tpu_torch.ops import int8_matmul as im

    a, w = _x1_args(16, 8, 32, seed=6, device=card)
    for bad in ((a.float(), w), (a, w.to(torch.uint8)), (a.cpu(), w), (a, w.cpu()), (a, w[:, :16].contiguous()),
                (a[0], w), (a.T.contiguous().T, w), (a, w.T.contiguous().T)):
        with pytest.raises(ValueError):
            im.int8_matmul(*bad)
    with pytest.raises(ValueError):  # K above 2**17 - 1 could overflow int32
        im.int8_matmul(torch.zeros((1, 1 << 17), dtype=torch.int8, device=card),
                       torch.zeros((1, 1 << 17), dtype=torch.int8, device=card))


def _epilogue_vectors(m, n, seed, device):
    """x_scales [M], w_scales, bias and GELU out_scales [N] at the magnitudes of
    a served BERT-base layer: products of about 1e5 dequantize to a few units."""
    rng = np.random.Generator(np.random.PCG64(seed))
    vec = {"x_scales": rng.random(m) * 0.04 + 0.01, "w_scales": rng.random(n) * 8e-4 + 2e-4,
           "bias": rng.standard_normal(n) * 0.1, "out_scales": (rng.random(n) * 8 + 2) / 127}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device) for k, v in vec.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [128, 256])
@pytest.mark.parametrize("k", [16, 45, 300, 3072])
@pytest.mark.parametrize("m", [1, 32, 37, 130])
def test_x1_int32_epilogue_is_exact_at_ragged_shapes(card, m, k, tile_n):
    from capreolus_tpu_torch.ops import int8_matmul as im

    n = 257  # off both tile widths
    a, w = _x1_args(m, n, k, seed=m + k + tile_n, device=card)
    if m == 37:  # one operand one byte off a 16-byte boundary
        w = torch.empty(w.numel() + 1, dtype=torch.int8, device=card)[1:].view(w.shape).copy_(w)
    before, copies = dict(im.int8_matmul.mode_launches), im.int8_matmul.pad_copies
    got = im.int8_matmul(a, w, tile_n=tile_n)
    torch.cuda.synchronize()
    assert im.int8_matmul.mode_launches["int32"] == before["int32"] + 1
    assert im.int8_matmul.pad_copies == copies + (2 if k % 16 else 1 if m == 37 else 0)
    assert torch.equal(got.cpu().to(torch.int64), a.cpu().to(torch.int64) @ w.cpu().to(torch.int64).T)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [128, 256])
@pytest.mark.parametrize("x_scales", [True, False], ids=["x_scales", "folded"])
@pytest.mark.parametrize("shape", [(37, 29, 45), (130, 257, 64), (300, 3072, 768), (257, 768, 3072)])
def test_x1_f32_epilogue_is_bit_identical_to_plain(card, shape, x_scales, tile_n):
    from capreolus_tpu_torch.ops import int8_matmul as im

    m, n, k = shape
    a, w = _x1_args(m, n, k, seed=sum(shape), device=card)
    vec = _epilogue_vectors(m, n, seed=k, device=card)
    xs = vec["x_scales"] if x_scales else None
    before = im.int8_matmul.mode_launches["f32"]
    got = im.int8_linear(a, w, vec["w_scales"], vec["bias"], xs, tile_n=tile_n)
    torch.cuda.synchronize()
    assert im.int8_matmul.mode_launches["f32"] == before + 1 and got.dtype == torch.float32
    assert torch.equal(got, im.int8_linear_plain(a, w, vec["w_scales"], vec["bias"], xs))
    assert torch.equal(im.int8_linear_mm(a, w, vec["w_scales"], vec["bias"], xs), got)


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", ["tanh", "none"])
@pytest.mark.parametrize("shape", [(300, 3072, 768), (130, 257, 64)])
def test_x1_gelu_epilogue_codes_within_one_step(card, shape, approximate):
    from capreolus_tpu_torch.ops import int8_matmul as im

    m, n, k = shape
    a, w = _x1_args(m, n, k, seed=sum(shape) + 1, device=card)
    vec = _epilogue_vectors(m, n, seed=k + 1, device=card)
    args = (a, w, vec["w_scales"], vec["bias"], vec["out_scales"], vec["x_scales"], approximate)
    before = im.int8_matmul.mode_launches["int8_gelu"]
    got = im.int8_linear_gelu(*args)
    torch.cuda.synchronize()
    assert im.int8_matmul.mode_launches["int8_gelu"] == before + 1 and got.dtype == torch.int8
    diff = (got.int() - im.int8_linear_gelu_plain(*args).int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-4, (int(diff.max()), int((diff > 0).sum()))
    assert bool((got.abs() <= 127).all()) and torch.equal(im.int8_linear_gelu_mm(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 768), (37, 45), (5, 3000), (3, 1028), (2, 16, 64)])
def test_q1_kernel_matches_plain_exactly(card, shape):
    from capreolus_tpu_torch.ops import quantization as pq

    x = torch.from_numpy(np.random.Generator(np.random.PCG64(sum(shape))).standard_normal(shape).astype(np.float32) * 3)
    x = x.to(card)
    x.view(-1, shape[-1])[1] = 0.0  # the 1e-6 floor
    before = pq.quantize_per_token.launches
    q, s = pq.quantize_per_token(x)
    torch.cuda.synchronize()
    assert pq.quantize_per_token.launches == before + 1
    want_q, want_s = pq.quantize_per_token_plain(x)
    assert torch.equal(q, want_q) and torch.equal(s, want_s) and s.shape == (*shape[:-1], 1)
    cpu_q, cpu_s = pq.quantize_per_token_plain(x.cpu())  # a true division on both devices
    assert torch.equal(q.cpu(), cpu_q) and torch.equal(s.cpu(), cpu_s)


@pytest.mark.cuda
def test_fused_wrappers_reject_what_the_kernels_do_not_take(card):
    from capreolus_tpu_torch.ops import int8_matmul as im
    from capreolus_tpu_torch.ops import quantization as pq

    a, w = _x1_args(16, 8, 32, seed=7, device=card)
    vec = _epilogue_vectors(16, 8, seed=7, device=card)
    ws, bias, os_, xs = vec["w_scales"], vec["bias"], vec["out_scales"], vec["x_scales"]
    strided = torch.rand(32, device=card)[::2]
    for bad in ((ws.double(), bias, xs), (ws[:7], bias, xs), (ws, bias.cpu(), xs), (ws, bias, xs[:15]),
                (ws, bias, xs[:, None]), (ws, bias, strided)):
        with pytest.raises(ValueError):
            im.int8_linear(a, w, *bad)
    with pytest.raises(ValueError):
        im.int8_linear(a.cpu(), w, ws, bias)
    with pytest.raises(ValueError):
        im.int8_linear_gelu(a, w, ws, bias, os_[:4], xs)
    with pytest.raises(ValueError):
        im.int8_linear_gelu(a, w, ws, bias, os_, xs, approximate="sigmoid")
    with pytest.raises(ValueError):
        im.int8_matmul(a, w, tile_n=64)
    for bad in (torch.randn(4, 8, device=card).double(), torch.randn(8, 4, device=card).T, torch.randn(4, 8)):
        with pytest.raises(ValueError):
            pq.quantize_per_token(bad)


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
        assert len(g) > 0
        assert_same_ranking(g, c, 1e-2)


@pytest.mark.cuda
def test_int8_bert_reranking_service_on_the_card_matches_cpu(card, tmp_path, monkeypatch):
    from capreolus_tpu_torch.convert import save_params
    from capreolus_tpu_torch.index import Index
    from capreolus_tpu_torch.ops import int8_matmul as im
    from capreolus_tpu_torch.ops import quantization as pq
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.serving import RerankingService

    monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / "cache")
    coll = _write_corpus(tmp_path / "corpus", np.random.Generator(np.random.PCG64(6)))
    cfg = {"pretrained": "tiny", "quantize": "int8", "extractor": {
        "maxseqlen": 128, "maxqlen": 8, "numpassages": 4, "passagelen": 100, "stride": 80, "index": {"collection": coll}}}
    gpu_reranker = Reranker.create("BERTMaxP", cfg)
    ckpt = save_params(seeded_bert_params(gpu_reranker.build_model(), seed=8, std=0.2), tmp_path / "bert.npz")
    index = Index.create("tpu", {"collection": coll})
    gpu = RerankingService(index, gpu_reranker, ckpt, topn=50, device=card)
    queries = ["w1 w7 w30", "w2 w250", "w399 w5 w6 w8"]

    before, before_k2 = im.int8_matmul.launches, fa.flash_attention.launches
    before_modes, before_q1, copies = dict(im.int8_matmul.mode_launches), pq.quantize_per_token.launches, \
        im.int8_matmul.pad_copies
    gpu_hits = gpu.search(queries, k=20)
    # tiny: 2 layers x 6 int8 products, one batch per query, plus the first request's calibration pass
    assert im.int8_matmul.launches == before + 12 * (len(queries) + 1)
    assert fa.flash_attention.launches == before_k2 + 2 * (len(queries) + 1)
    # per layer 3 per-token quantizations; the up-projection in the GELU epilogue but when calibrating
    assert pq.quantize_per_token.launches == before_q1 + 6 * (len(queries) + 1)
    modes = {key: im.int8_matmul.mode_launches[key] - before_modes[key] for key in before_modes}
    assert modes == {"int32": 0, "f32": 10 * len(queries) + 12, "int8_gelu": 2 * len(queries)}
    assert im.int8_matmul.pad_copies == copies
    assert all(len(hits) == 20 and all(np.isfinite(s) for _, s in hits) for hits in gpu_hits)

    # query 0's top 8 on the CPU with the card's weights and calibrated stats: each layer from the
    # card's input to that layer, then the head from the card's last hidden states
    model = gpu.reranker.model
    cpu_reranker = Reranker.create("BERTMaxP", cfg)
    cpu_model = cpu_reranker.build_model().eval()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    docids = [d for d, _ in gpu_hits[0][:8]]
    batch = gpu.rerank_batch("q0", queries[0], docids)
    seq_len = batch["pos_bert_input"].shape[-1]
    ids, seg, mask = (torch.from_numpy(batch[key].reshape(-1, seq_len)) for key in ("pos_bert_input", "pos_seg",
                                                                                    "pos_mask"))
    doc_mask = torch.from_numpy(batch["pos_mask"])
    with torch.inference_mode():
        keys = mask.bool()
        hidden = model.bert.embed(ids.to(card), seg.to(card))
        for i in range(2):
            out = getattr(model.bert, f"layer_{i}")(hidden, keys.to(card))
            err = (out.cpu() - getattr(cpu_model.bert, f"layer_{i}")(hidden.cpu(), keys)).abs()
            moved = float((err > 1e-4).float().mean())
            assert float(err.max()) <= INT8_LAYER_TOL and moved <= INT8_LAYER_MOVED_SHARE, (i, float(err.max()), moved)
            hidden = out
        raw = cpu_model.classifier(torch.tanh(cpu_model.bert.pooler(hidden.cpu()[:, 0])))[:, 0]
        head = cpu_reranker._head_scores(raw.reshape(doc_mask.shape[:2]), doc_mask).numpy()
        gpu_scores = gpu.reranker.test(batch, card).cpu().numpy()
    np.testing.assert_allclose(gpu_scores, head, rtol=1e-4, atol=1e-4)
    # the served request's scores of those docs: per-token quantization makes them independent of the batch
    served = dict(gpu_hits[0])
    np.testing.assert_allclose([served[d] for d in docids], gpu_scores, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["int8", "int4"])
def test_quantized_colbert_service_on_the_card_matches_cpu(card, tmp_path, monkeypatch, quantize):
    from capreolus_tpu_torch.ops import int8_matmul as im
    from capreolus_tpu_torch.serving import ColbertRetrievalService

    path = _write_corpus(tmp_path / "corpus", np.random.Generator(np.random.PCG64(7)), min_len=20, max_len=300)
    queries = ["w1 w7 w30", "w2 w250", "w399 w5 w6 w8", "w11", "w3 w4"]
    config = {"allowrandominit": True, "dim": 8, "maxdoclen": 32, "maxqlen": 8, "batch": 4, "max_k": 20,
              "quantize": quantize, "rescore": 40}
    services = {}
    for name, device in (("gpu", card), ("cpu", "cpu")):
        monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / f"cache_{name}")
        services[name] = ColbertRetrievalService.from_config(collection="dummy", collection_path=path["path"],
                                                             device=device, **config)
    before, before_k3, before_int32 = im.int8_matmul.launches, ms.maxsim.launches, im.int8_matmul.mode_launches["int32"]
    gpu_hits = services["gpu"].search(queries, k=20)
    assert im.int8_matmul.launches == before + 2 and ms.maxsim.launches == before_k3  # one chunk per query batch
    assert im.int8_matmul.mode_launches["int32"] == before_int32 + 2  # the int32 epilogue
    for g, c in zip(gpu_hits, services["cpu"].search(queries, k=20)):
        assert len(g) > 0
        assert_same_ranking(g, c, 1e-2)


# ---------------------------------------------------------------- the rank task's sparse searchers
RANK_RTOL = 1e-6  # exact sparse scores, card vs CPU: f32 formulas whose ops may round apart by an ulp
RUN_FILE_ATOL = 1e-6  # a run file prints scores with 6 decimals


@pytest.fixture(scope="module")
def golden5k(tmp_path_factory):
    """A 5,000-doc corpus of the JAX suite's golden recipe, registered as the
    port's ``golden5k`` collection and benchmark."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the rank task's card run")
    from chip_smoke import golden_corpus, register_golden, write_golden

    docs, topics, qrels = golden_corpus(num_docs=5000)
    paths = write_golden(docs, topics, qrels, str(tmp_path_factory.mktemp("golden5k")))
    register_golden(*paths, sorted(topics), name="golden5k")
    return "golden5k"


@pytest.mark.cuda
@pytest.mark.parametrize("searcher", ["BM25", "BM25Grid"])
@pytest.mark.parametrize("benchmark", ["dummy", "golden5k"])
def test_rank_search_on_the_card_matches_cpu(card, request, tmp_path, monkeypatch, benchmark, searcher):
    """rank.search on the card and on the CPU: the same run files, the same
    docids per query, scores within 1e-6 relative (plus the run files'
    6-decimal rounding)."""
    from capreolus_tpu_torch.task import Task
    from capreolus_tpu_torch.utils.trec import load_trec_run

    if benchmark != "dummy":
        request.getfixturevalue(benchmark)
    monkeypatch.setitem(constants, "CACHE_BASE_PATH", tmp_path / "cache")
    runs = {}
    for device in ("cuda", "cpu"):
        monkeypatch.setitem(constants, "RESULTS_BASE_PATH", tmp_path / f"results_{device}")
        task = Task.create("rank", {"benchmark": {"name": benchmark}, "searcher": {"name": searcher}})
        task.device = device
        out = task.search()
        runs[device] = {p.name: load_trec_run(p) for p in out.iterdir() if p.name != "done"}
        assert task.searcher.engine_calls >= 1
    assert sorted(runs["cuda"]) == sorted(runs["cpu"]) and len(runs["cuda"]) == (1 if searcher == "BM25" else 100)
    for name, card_run in runs["cuda"].items():
        cpu_run = runs["cpu"][name]
        assert list(card_run) == list(cpu_run)
        for qid, docs in card_run.items():
            assert list(docs) == list(cpu_run[qid]), (name, qid)
            np.testing.assert_allclose(list(docs.values()), list(cpu_run[qid].values()),
                                       rtol=RANK_RTOL, atol=RUN_FILE_ATOL)


# ---------------------------------------------------------------- training
@pytest.mark.cuda
def test_k1_and_k2_refuse_tensors_that_require_grad(card):
    """Neither kernel has a backward: a tensor that requires grad raises, and
    nothing is launched (no silent detach, no silent fallback)."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 32, generator=gen).to(card)
    mask = torch.ones(1, 8, dtype=torch.bool, device=card)
    before = fa.flash_attention.launches
    for which in range(3):
        args = [q.clone(), q.clone(), q.clone()]
        args[which].requires_grad_(True)
        with pytest.raises(ValueError, match="requires grad"):
            fa.flash_attention(*args, mask)
    assert fa.flash_attention.launches == before
    emb = torch.randn(6, 8, generator=gen).to(card).requires_grad_(True)
    toks = torch.tensor([[1, 2, 0]], device=card)
    mus = torch.tensor(KNRM_MUS, device=card)
    sigmas = torch.tensor(KNRM_SIGMAS, device=card)
    before = simmat.knrm_pool.launches
    with pytest.raises(ValueError, match="require grad"):
        simmat.knrm_simmat_pool(emb, toks, toks, mus, sigmas)
    with pytest.raises(ValueError, match="require grad"):
        simmat.knrm_simmat_pool(emb.detach(), toks, toks, mus.requires_grad_(True), sigmas)
    assert simmat.knrm_pool.launches == before


@pytest.fixture(scope="module")
def rerank_golden(tmp_path_factory):
    """The JAX suite's rerank golden (chip_smoke's copy) as the port's
    ``rerank_golden`` benchmark, with the port's caches under a tmpdir."""
    from chip_smoke import setup_rerank_golden

    base = tmp_path_factory.mktemp("rerank_golden")
    saved = constants["CACHE_BASE_PATH"], constants["RESULTS_BASE_PATH"]
    constants["CACHE_BASE_PATH"], constants["RESULTS_BASE_PATH"] = base / "cache", base / "results"
    try:
        yield setup_rerank_golden(str(base))
    finally:
        constants["CACHE_BASE_PATH"], constants["RESULTS_BASE_PATH"] = saved


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["knrm", "knrm-frozen", "tiny-bert"])
def test_training_step_on_the_card_equals_the_cpus(card, rerank_golden, which):
    """Step 1 from one init and one batch: the loss and every gradient on the
    card within 1e-4 (relative to each tensor's largest entry, or to 1e-3 of
    the model's largest where that is larger: the attention key bias's
    gradient is 0 but for rounding) of the CPU's (``chip_smoke.step_parity``). A frozen KNRM's step launches K1 once per
    forward; a BERT step launches no K2. With trainable kernels the
    exact-match kernel's (sigma 0.001) mu and sigma are left out: their
    gradient is the rounding of a token's cosine with itself."""
    from chip_smoke import RERANK_GOLDEN_CONFIGS, rerank_task, step_parity, training_batch

    cfg = dict(RERANK_GOLDEN_CONFIGS["BERTMaxP" if which == "tiny-bert" else "KNRM"])
    exclude = None
    if which == "knrm-frozen":
        cfg.update(finetune=False, gradkernels=False)
    elif which == "knrm":
        exact = [KNRM_SIGMAS.index(0.001)]
        exclude = {"mus": exact, "sigmas": exact}
    else:
        cfg["hidden_dropout_prob"] = 0.0
    task = rerank_task(cfg, "cuda")
    result = step_parity(task, training_batch(task, 8), which, exclude=exclude)
    assert result["launches"]["knrm_pool"] == (2 if which == "knrm-frozen" else 0)
    assert result["launches"]["flash_attention"] == 0


@pytest.mark.cuda
def test_bert_base_training_step_launches_no_k2_and_a_prediction_one_per_layer(card):
    """BERT-base (12 layers) on the card: a training step takes the
    differentiable attention (no K2 launch) and moves every encoder weight
    (the head's bias alone stays: the pairwise loss cancels it); a prediction
    batch launches K2 once per layer."""
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.trainer.torch_trainer import TorchTrainer

    reranker = Reranker.create("BERTMaxP", {"pretrained": "bert-base-uncased", "allowrandominit": True,
                                            "trainer": {"batch": 2, "lr": 1e-3, "bertlr": 1e-3},
                                            "extractor": {"index": {"collection": {"name": "dummy"}}}})
    model = reranker.init_params(0).to(card)
    trainer = reranker.trainer
    assert isinstance(trainer, TorchTrainer)
    optimizer = trainer.make_optimizer(reranker, model)
    gen = np.random.default_rng(0)
    ids = gen.integers(1000, 30000, size=(1, 2, 64))
    mask = np.ones_like(ids)
    mask[..., 40:] = 0
    batch = {"pos_bert_input": ids, "pos_mask": mask, "pos_seg": np.zeros_like(ids),
             "neg_bert_input": ids[:, ::-1].copy(), "neg_mask": mask, "neg_seg": np.zeros_like(ids),
             "label": np.tile(np.array([1.0, 0.0], np.float32), (1, 2, 1))}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    launches = fa.flash_attention.launches
    loss = trainer.train_step(reranker, model, optimizer, batch, 0, trainer.step_seed(0, 0))
    torch.cuda.synchronize()
    assert np.isfinite(float(loss))
    assert fa.flash_attention.launches == launches
    unmoved = [n for n, p in model.named_parameters() if torch.equal(p.detach(), before[n])]
    assert unmoved == ["classifier.bias"], f"weights a training step left unchanged: {unmoved[:5]}"
    model.eval()
    with torch.no_grad():
        scores = reranker.test({k: v[0] for k, v in batch.items()}, card)
    assert fa.flash_attention.launches == launches + 12 and torch.isfinite(scores).all()


# ---------------------------------------------------------------- the sparse engine
@pytest.fixture(scope="module")
def sparse_corpus():
    """A corpus whose terms each live in a band of doc ordinals (6k docs, 120k
    draws; block-max pruning drops tiles at k=10) and 96 queries of 4 terms
    of df > 50, in batches of 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sparse engine's card run")
    from capreolus_tpu_torch.index.synth import assemble_index

    num_docs, num_terms = 6000, 800
    rng = np.random.Generator(np.random.PCG64(7))
    z = rng.zipf(1.35, size=240_000)
    terms = (z[z <= num_terms][:120_000] - 1).astype(np.int64)
    centers = rng.integers(0, num_docs, size=num_terms)
    docs = (centers[terms] + rng.integers(-num_docs // 20, num_docs // 20, size=len(terms))) % num_docs
    data = assemble_index(terms, docs, rng, num_docs, num_terms)
    qrng = np.random.Generator(np.random.PCG64(1))
    cand = np.where(data.df_array > 50)[0]
    queries = [[(int(t), 1.0) for t in qrng.choice(cand, size=4, replace=False)] for _ in range(96)]
    return data, [queries[i:i + 32] for i in range(0, 96, 32)]


def _sparse_engine(data, device, **kw):
    from capreolus_tpu_torch.searcher.scoring import DeviceIndex, ScoringEngine

    return ScoringEngine(DeviceIndex(data, device, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("topk", [10, 1000])
def test_tiered_on_the_card_matches_cpu(card, sparse_corpus, topk):
    """Tiered BM25 on the card and on the CPU: the same ordinals (the same
    stable sorts on the same scores; an ulp of the f32 formula may split a tie
    only between docs that score within RANK_RTOL), scores within RANK_RTOL,
    and the exact path's ranking within 1e-5 (a tree sum against a sequential
    sum)."""
    data, batches = sparse_corpus
    queries = [q for b in batches for q in b]
    params = {"k1": 0.9, "b": 0.4}
    gpu = _sparse_engine(data, card).search(queries, params=params, topk=topk, exact_topk=False)
    cpu = _sparse_engine(data, "cpu").search(queries, params=params, topk=topk, exact_topk=False)
    exact = _sparse_engine(data, card).search(queries, params=params, topk=topk, exact_topk=True)
    for q in range(len(queries)):
        valid = cpu[0][q] > 0
        assert (gpu[0][q] > 0).sum() == valid.sum() == (exact[0][q] > 0).sum()
        hits = lambda r: list(zip(r[1][q][valid].tolist(), r[0][q][valid].tolist()))  # noqa: E731
        assert_same_ranking(hits(gpu), hits(cpu), RANK_RTOL * float(cpu[0][q].max()), f"query {q}")
        assert_same_ranking(hits(gpu), hits(exact), 1e-5 * float(cpu[0][q].max()), f"query {q} vs exact")


@pytest.mark.cuda
def test_pruned_streamed_and_packed_on_the_card_are_bit_identical(card, sparse_corpus):
    """On the card, the pruned stream (forced and adaptive) and a streaming
    index four times over its budget give the resident exhaustive tiered bits,
    with bench.py's bf16 scores and packed ordinals, whose words equal the
    CPU's."""
    data, batches = sparse_corpus
    kw = dict(params={"k1": 0.9, "b": 0.4}, topk=10, materialize=False, score_dtype="bfloat16", pack_ords=True,
              exact_topk=False)  # 6k docs would take the exact path by default
    engine = _sparse_engine(data, card)
    streaming = _sparse_engine(data, card, hbm_budget=engine.dindex.tile_bytes / 4)
    assert streaming.dindex.streaming and streaming.dindex.doc_tiles is None
    stream_kw = {k: v for k, v in kw.items() if k != "exact_topk"}
    ref = [r.get() for r in engine.search_stream(batches, **stream_kw)]
    runs = {"forced": engine.search_pruned_stream(batches, adaptive=False, **stream_kw),
            "adaptive": engine.search_pruned_stream(batches, **stream_kw),
            "streamed": streaming.search_stream(batches, **stream_kw),
            "streamed_pruned": streaming.search_pruned_stream(batches, adaptive=False, **stream_kw)}
    for name, run in runs.items():
        for (s, o), (rs, ro) in zip((r.get() for r in run), ref):
            np.testing.assert_array_equal(o, ro, err_msg=name)
            np.testing.assert_array_equal(s, rs, err_msg=name)
    st = engine.last_prune_stats
    assert st["kept_tiles"] < st["total_tiles"], st
    assert 0 < streaming.last_stream_stats["tiles_uploaded"] < streaming.last_stream_stats["total_tiles"]
    gpu = engine.search(batches[0], **kw)
    cpu = _sparse_engine(data, "cpu").search(batches[0], **kw)
    assert gpu.ords.is_cuda and gpu.ords.dtype == torch.int32 and gpu._event is not None
    assert gpu._host[1].is_pinned() and gpu._host[0].dtype == torch.bfloat16
    gw, cw = gpu.get(), cpu.get()
    np.testing.assert_array_equal(gpu._host[1].numpy(), cpu.ords.numpy())  # the packed words, bit for bit
    np.testing.assert_array_equal(gw[1], cw[1])
    np.testing.assert_allclose(gw[0], cw[0], rtol=1e-2)  # bf16: an ulp of f32 can round across a bf16 step
