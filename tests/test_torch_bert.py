"""Slice 2 module by module: the PyTorch port's BERT tokenizer, bertpassage
extractor, K2's plain version, encoder and BERTMaxP against the JAX package,
on the CPU, where the port's attention runs ``attention_plain``.

Tolerances (both sides f32 unless stated):
- ``attention_plain`` vs ``_xla_attention``: 1e-5 (one softmax; f32 rounding).
- ``attention_plain`` vs the Pallas ``_flash_attention_tpu`` in interpret mode:
  2e-4 at f32 (the JAX suite's own tolerance for the kernel) and 2e-2 with bf16
  inputs (the outputs are rounded to bf16).
- tokens, ids and passage features: equal.
- BERTMaxP scores: 1e-4 at the tiny config, 2e-4 at BERT-base width (one
  layer): flax's LayerNorm takes the variance as E[x^2] - E[x]^2, torch in two
  passes, and the matmuls sum in other orders.
- encoders from converted HF weights: 1e-5.

The JAX berttokenizer first tries HuggingFace's tokenizer for its
``pretrained`` name; the tests give it a name that cannot exist, so that it
takes the same offline branch as the port (which has no HF branch).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.extractor import Extractor as JaxExtractor  # noqa: E402
from capreolus_tpu.ops.flash_attention import _flash_attention_tpu, _xla_attention  # noqa: E402
from capreolus_tpu.reranker import Reranker as JaxReranker  # noqa: E402
from capreolus_tpu.reranker.bert import BertConfig as JaxBertConfig  # noqa: E402
from capreolus_tpu.reranker.bert import convert_hf_weights as jax_convert_hf_weights  # noqa: E402
from capreolus_tpu.reranker.bert import get_bert_config as jax_get_bert_config  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import KNOWN_CONFIGS as JAX_KNOWN_CONFIGS  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import BertEncoder as JaxBertEncoder  # noqa: E402
from capreolus_tpu.reranker.bert_rerankers import _BertScorer as JaxBertScorer  # noqa: E402
from capreolus_tpu.reranker.bert_rerankers import aggregate_passage_scores as jax_aggregate  # noqa: E402
from capreolus_tpu.tokenizer import Tokenizer as JaxTokenizer  # noqa: E402
from capreolus_tpu_torch.convert import bert_state_dict  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.extractor import Extractor as TorchExtractor  # noqa: E402
from capreolus_tpu_torch.ops import flash_attention as fa  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.reranker.bert import BertConfig, BertEncoder, convert_hf_weights, get_bert_config  # noqa: E402
from capreolus_tpu_torch.reranker.bert import load_pretrained_encoder  # noqa: E402
from capreolus_tpu_torch.reranker.bert_rerankers import _BertScorer, aggregate_passage_scores  # noqa: E402
from capreolus_tpu_torch.tokenizer import Tokenizer as TorchTokenizer  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_knrm import flatten_params  # noqa: E402

OFFLINE_TOKENIZER = {"pretrained": "definitely-not-a-real-model-xyz"}
EXTRACTOR_TINY = {"maxseqlen": 64, "maxqlen": 8, "numpassages": 2, "passagelen": 20, "stride": 10}
TINY = JaxBertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)
TINY_TORCH = BertConfig(vocab_size=1024, hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128)


def assert_within(got, want, tol, what):
    """assert_allclose at rtol = atol = ``tol``, printing the measured max
    abs error (``pytest -s`` shows it)."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    print(f"{what}: max |port - JAX| {float(np.max(np.abs(got - want))):.3g} (tolerance {tol})")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------- K2's plain version
def attention_inputs(shape, seed):
    """q, k, v [B, H, L, D] f32 and a [B, L] key mask: ragged key counts, and
    the last batch element with every key masked."""
    b, h, l, d = shape
    rng = np.random.Generator(np.random.PCG64(seed))
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, l), dtype=bool)
    for i, n in enumerate(rng.integers(1, l + 1, size=b)):
        mask[i, :n] = True
    mask[0, l // 3] = False  # a hole inside the unmasked run
    mask[-1] = False
    return q, k, v, mask


def port_attention(q, k, v, mask, dtype=torch.float32):
    out = fa.attention_plain(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)), torch.from_numpy(mask))
    return out.float().numpy()


@pytest.mark.parametrize("shape", [(2, 2, 64, 32), (2, 12, 128, 64)])
def test_attention_plain_matches_xla_attention(shape):
    q, k, v, mask = attention_inputs(shape, seed=sum(shape))
    want = np.asarray(_xla_attention(*(jnp.asarray(x) for x in (q, k, v, mask))))
    got = port_attention(q, k, v, mask)
    assert_within(got, want, 1e-5, f"attention_plain vs _xla_attention {shape}")
    # the fully masked row is the mean of V in both
    np.testing.assert_allclose(got[-1], np.broadcast_to(v[-1].mean(axis=1, keepdims=True), v[-1].shape),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,seq_len,head_dim,tol", [
    ("float32", 128, 32, 2e-4), ("float32", 256, 64, 2e-4),
    ("bfloat16", 128, 32, 2e-2), ("bfloat16", 256, 64, 2e-2),
])
def test_attention_plain_matches_pallas_kernel_interpret(dtype, seq_len, head_dim, tol):
    from jax.experimental import pallas as pl

    q, k, v, mask = attention_inputs((2, 2, seq_len, head_dim), seed=seq_len + head_dim)
    jq, jk, jv = (jnp.asarray(x, dtype=dtype) for x in (q, k, v))
    with mock.patch.object(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)):
        want = np.asarray(_flash_attention_tpu(jq, jk, jv, jnp.asarray(mask)).astype(jnp.float32))
    # the same (bf16-rounded) values on the port's side
    q, k, v = (np.array(x.astype(jnp.float32)) for x in (jq, jk, jv))
    got = port_attention(q, k, v, mask, dtype=getattr(torch, dtype))
    assert_within(got, want, tol, f"attention_plain vs Pallas (interpret) {dtype} L={seq_len} D={head_dim}")


def test_cpu_attention_never_takes_the_kernel(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("the CUDA binding was called for CPU tensors")

    monkeypatch.setattr(fa, "flash_attention", boom)
    q, k, v, mask = (torch.from_numpy(x) for x in attention_inputs((2, 2, 16, 32), seed=3))
    torch.testing.assert_close(fa.multihead_attention(q, k, v, mask), fa.attention_plain(q, k, v, mask))
    model = _BertScorer(TINY_TORCH).eval()
    ids = torch.randint(0, 1024, (2, 2, 16))
    with torch.inference_mode():
        assert model(ids, torch.ones_like(ids), torch.zeros_like(ids)).shape == (2, 2)


def test_attention_raises_off_cpu_and_cuda():
    q = torch.empty((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.multihead_attention(q, q, q, torch.ones((1, 4), dtype=torch.bool, device="meta"))
    cpu = torch.zeros((1, 1, 4, 32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fa.flash_attention(cpu, cpu, cpu, torch.ones((1, 4), dtype=torch.bool))


# ---------------------------------------------------------------- tokenizer
TEXTS = [
    "The quick brown Foxes running, unaffable hello!",
    "CAFÉ naïve Zürich 123 12 1-2 $12",
    "punct:(nested)? \"quotes\" 'single' -- dashes, under_scores",
    "the [CLS] quick x[SEP]y [MASK], [UNK]!",
    "",
    "   \t\nwhitespace everywhere",
    "中文 mixed with english",
]
VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "quick", "brown", "fox", "##es", "run", "##ning", "un", "##affable", "hello",
    "cafe", "naive", "zurich", "1", "2", "12", "##2", "$", ",", ".", "!", "?", "-", "'", '"',
    "(", ")", ":", "_", "punct", "nested", "quotes", "single", "dash", "##es", "x", "y",
    "white", "##space", "every", "##where", "中", "文", "mixed", "with", "english", "under", "##scores",
]


def _tokenizer_pair(config):
    return (JaxTokenizer.create("berttokenizer", dict(OFFLINE_TOKENIZER, **config)),
            TorchTokenizer.create("berttokenizer", dict(OFFLINE_TOKENIZER, **config)))


def _assert_same_tokenizer(jax_tok, port_tok):
    for text in TEXTS:
        toks = port_tok.tokenize(text)
        assert toks == jax_tok.tokenize(text), text
        assert port_tok.convert_tokens_to_ids(toks) == jax_tok.convert_tokens_to_ids(toks), text
    assert port_tok.tokenize(TEXTS[:2]) == jax_tok.tokenize(TEXTS[:2])
    for name in ("pad_token", "cls_token", "sep_token"):
        assert getattr(port_tok, name) == getattr(jax_tok, name), name


def test_berttokenizer_hash_fallback_matches_jax():
    jax_tok, port_tok = _tokenizer_pair({})
    _assert_same_tokenizer(jax_tok, port_tok)
    assert type(jax_tok.bert_tokenizer).__name__ == type(port_tok.bert_tokenizer).__name__ == "_HashWordpieceFallback"
    ids = port_tok.convert_tokens_to_ids(port_tok.tokenize(TEXTS[0]) + ["[PAD]", "[CLS]", "[SEP]", "[MASK]"])
    assert ids[-4:] == [0, 101, 102, 103] and all(1000 <= i < 30522 for i in ids[:-4])


def test_berttokenizer_wordpiece_matches_jax(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    jax_tok, port_tok = _tokenizer_pair({"vocabfile": str(path)})
    _assert_same_tokenizer(jax_tok, port_tok)
    assert type(port_tok.bert_tokenizer).__name__ == "WordPieceTokenizer"
    assert port_tok.tokenize("unaffable foxes") == ["un", "##affable", "fox", "##es"]


# ---------------------------------------------------------------- bertpassage
@pytest.mark.parametrize("config", [EXTRACTOR_TINY, {}], ids=["tiny", "defaults"])
def test_bertpassage_features_match_jax(tmpdir_as_cache, torch_cache, config):
    cfg = dict(config, tokenizer=OFFLINE_TOKENIZER, index={"collection": {"name": "dummy"}})
    jax_ext, port_ext = JaxExtractor.create("bertpassage", cfg), TorchExtractor.create("bertpassage", cfg)
    topics = {"301": "orbital telescope launched", "302": "whales in the ocean, migrating south"}
    docids = ["D001", "D002", "D003"]
    for ext in (jax_ext, port_ext):
        ext.preprocess(list(topics), docids, topics)
    numpassages, maxseqlen = port_ext.config["numpassages"], port_ext.config["maxseqlen"]
    for qid in topics:
        for docid in docids:
            want = jax_ext.id2vec(qid, docid, label=[1, 0], training=False)
            got = port_ext.id2vec(qid, docid, label=[1, 0], training=False)
            assert got["pos_bert_input"].shape == (numpassages, maxseqlen)
            for key in ("pos_bert_input", "pos_mask", "pos_seg", "neg_bert_input", "label"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{qid} {docid} {key}")
    # training: one seeded random valid passage per doc, and a negative doc
    for _ in range(3):
        want = jax_ext.id2vec("301", "D001", "D002", label=[1, 0], training=True)
        got = port_ext.id2vec("301", "D001", "D002", label=[1, 0], training=True)
        for key in ("pos_bert_input", "pos_mask", "pos_seg", "neg_bert_input", "neg_mask", "neg_seg"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------- BERTMaxP
def bert_batch(b, p, l, qlen, seed, vocab=30522):
    """[B, P, L] bertpassage-like inputs: ``[CLS] q [SEP] passage [SEP]`` with
    ragged passage lengths, and pad passages (``[CLS] q [SEP] [PAD] [SEP]``,
    their [PAD] masked) after each doc's real ones."""
    rng = np.random.Generator(np.random.PCG64(seed))
    inp = rng.integers(1000, vocab, size=(b, p, l))
    mask = np.zeros((b, p, l), dtype=np.int64)
    seg = np.zeros((b, p, l), dtype=np.int64)
    seg[..., qlen + 2:] = 1
    real = rng.integers(1, p + 1, size=b)
    real[0] = 1  # one doc with a single real passage
    for i in range(b):
        for j in range(p):
            n = int(rng.integers(qlen + 4, l + 1)) if j < real[i] else qlen + 4
            mask[i, j, :n] = 1
            inp[i, j, n:] = 0
            if j >= real[i]:
                mask[i, j, qlen + 2] = 0
                inp[i, j, qlen + 2] = 0
    inp[..., 0] = 101
    return {"pos_bert_input": inp, "pos_mask": mask, "pos_seg": seg}


def _reranker_pair(options):
    cfg = dict(options, extractor=dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER,
                                       index={"collection": {"name": "dummy"}}))
    return JaxReranker.create("BERTMaxP", cfg), TorchReranker.create("BERTMaxP", cfg)


@pytest.mark.parametrize("aggregation", ["max", "first", "sum", "avg"])
def test_bertmaxp_tiny_matches_jax(aggregation):
    jax_rr, port_rr = _reranker_pair({"pretrained": "tiny", "aggregation": aggregation})
    batch = bert_batch(3, 4, 64, qlen=5, seed=11, vocab=5000)  # ids above the tiny vocab wrap around
    params = jax_rr.init_params(jax.random.PRNGKey(7), batch)
    want = np.asarray(jax_rr.test(params, batch))
    port_rr.build_model().load_state_dict(bert_state_dict(flatten_params(params)))
    port_rr.model.eval()
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
    assert got.shape == (3,)
    assert_within(got, want, 1e-4, f"BERTMaxP tiny, aggregation {aggregation}")


def test_pad_passages_count_in_the_aggregation():
    """A pad passage keeps ``[CLS] q [SEP] .. [SEP]`` unmasked, so
    ``mask.sum(-1) > 0`` counts it: its score enters the max, the sum and the
    average, as in the JAX reranker."""
    _, port_rr = _reranker_pair({"pretrained": "tiny"})
    model = port_rr.build_model().eval()
    batch = {k: torch.from_numpy(v) for k, v in bert_batch(3, 4, 64, qlen=5, seed=12).items()}
    assert bool(port_rr._passage_mask(batch["pos_mask"]).all())
    with torch.inference_mode():
        raw = model(batch["pos_bert_input"], batch["pos_mask"], batch["pos_seg"])
        torch.testing.assert_close(port_rr.test(batch, "cpu"), raw.max(dim=1).values)
    pads_only = torch.zeros(1, 2, 64, dtype=torch.int64)
    assert port_rr._passage_mask(pads_only).tolist() == [[False, False]]


@pytest.mark.parametrize("mode", ["max", "first", "sum", "avg"])
def test_aggregate_passage_scores_matches_jax(mode):
    rng = np.random.Generator(np.random.PCG64(5))
    scores = rng.standard_normal((4, 3)).astype(np.float32)
    pmask = np.array([[1, 1, 1], [1, 0, 0], [0, 1, 0], [0, 0, 0]], dtype=bool)
    want = np.asarray(jax_aggregate(jnp.asarray(scores), jnp.asarray(pmask), mode))
    got = aggregate_passage_scores(torch.from_numpy(scores), torch.from_numpy(pmask), mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    one = aggregate_passage_scores(torch.from_numpy(scores[:, :1]), torch.from_numpy(pmask[:, :1]), mode)
    np.testing.assert_array_equal(one.numpy(), scores[:, 0])


def test_bert_base_width_one_layer_matches_jax():
    """hidden 768, 12 heads of 64, FFN 3072, vocab 30522, one layer; 2 docs x 2 passages x 128."""
    batch = bert_batch(2, 2, 128, qlen=12, seed=13)
    args = [batch[k] for k in ("pos_bert_input", "pos_mask", "pos_seg")]
    jax_model = JaxBertScorer(JaxBertConfig(num_layers=1))
    params = jax_model.init(jax.random.PRNGKey(3), *args)
    want = np.asarray(jax_model.apply(params, *args))
    model = _BertScorer(BertConfig(num_layers=1))
    model.load_state_dict(bert_state_dict(flatten_params(params)))
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == (2, 2)
    assert_within(got, want, 2e-4, "BERT-base width, one layer, passage scores")


# ---------------------------------------------------------------- weights and configs
def hf_state_dict(prefix, cfg, pooler, seed):
    """A HuggingFace-named BERT/ELECTRA state dict at ``cfg``'s geometry."""
    rng = np.random.Generator(np.random.PCG64(seed))
    h, inter = cfg.hidden_size, cfg.intermediate_size

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    sd = {f"{prefix}embeddings.word_embeddings.weight": w(cfg.vocab_size, h),
          f"{prefix}embeddings.position_embeddings.weight": w(cfg.max_position, h),
          f"{prefix}embeddings.token_type_embeddings.weight": w(cfg.type_vocab_size, h),
          f"{prefix}embeddings.LayerNorm.weight": 1 + w(h), f"{prefix}embeddings.LayerNorm.bias": w(h)}
    for i in range(cfg.num_layers):
        pre = f"{prefix}encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (inter, h)), ("output.dense", (h, inter))):
            sd[pre + name + ".weight"], sd[pre + name + ".bias"] = w(*shape), w(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[pre + name + ".weight"], sd[pre + name + ".bias"] = 1 + w(h), w(h)
    if pooler:
        sd[f"{prefix}pooler.dense.weight"], sd[f"{prefix}pooler.dense.bias"] = w(h, h), w(h)
    return sd


@pytest.mark.parametrize("prefix,pooler", [("bert.", True), ("electra.", False)])
def test_convert_hf_weights_matches_jax(prefix, pooler):
    sd = hf_state_dict(prefix, TINY, pooler, seed=len(prefix))
    batch = bert_batch(2, 1, 32, qlen=4, seed=14, vocab=1024)
    ids, mask, seg = (batch[k][:, 0] for k in ("pos_bert_input", "pos_mask", "pos_seg"))
    want_hidden, want_pooled, _ = JaxBertEncoder(TINY).apply({"params": jax_convert_hf_weights(sd, TINY)},
                                                             ids, mask, seg)
    encoder = BertEncoder(TINY_TORCH)
    encoder.load_state_dict(convert_hf_weights({k: torch.from_numpy(v) for k, v in sd.items()}, TINY_TORCH))
    with torch.inference_mode():
        hidden, pooled = encoder.eval()(*(torch.from_numpy(a) for a in (ids, mask, seg)))
    assert_within(hidden.numpy(), want_hidden, 1e-5, f"encoder from {prefix} HF weights, hidden")
    assert_within(pooled.numpy(), want_pooled, 1e-5, f"encoder from {prefix} HF weights, pooled")


def test_named_configs_match_jax():
    for name in list(JAX_KNOWN_CONFIGS) + ["bert-base-msmarco", "mb", "electra-base", "unknown-model"]:
        jax_cfg, port_cfg = jax_get_bert_config(name), get_bert_config(name)
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                      "max_position", "type_vocab_size", "layer_norm_eps", "gelu_approximate"):
            assert getattr(port_cfg, field) == getattr(jax_cfg, field), (name, field)


def test_load_pretrained_encoder_is_offline():
    assert load_pretrained_encoder("tiny") == (get_bert_config("tiny"), None)
    with pytest.raises(RuntimeError, match="refusing to continue with random initialization"):
        load_pretrained_encoder("bert-base-uncased")
    assert load_pretrained_encoder("bert-base-msmarco", allow_random_init=True) == (BertConfig(), None)


@pytest.mark.parametrize("module,options", [
    ("reranker", {"quantize": "int8", "lora": 4}), ("reranker", {"moeexperts": 2}), ("reranker", {"lora": 4}),
    ("extractor", {"sentences": True}),
])
def test_unported_options_raise(module, options):
    extractor = dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, index={"collection": {"name": "dummy"}})
    if module == "extractor":
        extractor.update(options)
        options = {}
    with pytest.raises(ConfigError, match="not ported"):
        TorchReranker.create("BERTMaxP", dict(options, pretrained="tiny", extractor=extractor))


@pytest.mark.parametrize("name", ["ptBERTMaxP", "TFBERTMaxP", "TFVanillaBERT"])
def test_reference_aliases_resolve(name):
    reranker = TorchReranker.create(name, {"pretrained": "tiny", "extractor": {
        "tokenizer": OFFLINE_TOKENIZER, "index": {"collection": {"name": "dummy"}}}})
    assert isinstance(reranker.build_model(), _BertScorer)
    assert reranker.config["aggregation"] == ("first" if name == "TFVanillaBERT" else "max")
