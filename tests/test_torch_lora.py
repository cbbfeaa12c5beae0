"""LoRA in the PyTorch port (``reranker.lora``, ``LoRAAdapter`` in
``reranker/bert/encoder.py``) against the JAX package on the CPU: rank-r
adapters on every attention's query and value projections, the base encoder
frozen, adapter-only checkpoints.

Tolerances:
- a new LoRA model against its base model: 1e-6 (the up-projection starts at
  zero, so the adapters add exactly 0; the JAX suite's ``test_lora.py``).
- scores with non-zero adapters carried from JAX: 1e-5 at the tiny config
  (f32 sums in other orders, as the f32 BERT tests measure).
- training: ``tests/test_torch_trainer.py``'s ``check_training_matches_jax``
  (the frozen base bit-identical after 3 Adam steps; adapters and head within
  1e-4 of the learning rate on the same gradients).
- int8 with LoRA, with the stats JAX calibrated: 1e-4, the int8 encoder
  tolerance (``tests/test_torch_int8.py``).
- a LoRA dev.best served by both packages' ``RerankingService`` over a
  pretrained checkpoint directory: the same docids in the same order, scores
  within 1e-4.
"""

import json

import jax
import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.index import Index as JaxIndex  # noqa: E402
from capreolus_tpu.reranker import Reranker as JaxReranker  # noqa: E402
from capreolus_tpu.serving import RerankingService as JaxRerankingService  # noqa: E402
from capreolus_tpu.trainer.jax_trainer import collate as jax_collate  # noqa: E402
from capreolus_tpu_torch.convert import flax_flat_params, load_params  # noqa: E402
from capreolus_tpu_torch.index import Index as TorchIndex  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.reranker.bert.encoder import LoRAAdapter  # noqa: E402
from capreolus_tpu_torch.serving import RerankingService  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER, assert_within, with_adapters  # noqa: E402
from test_torch_checkpoint import TINY_HF  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_knrm import flatten_params  # noqa: E402
from test_torch_trainer import (bert_pair, check_training_matches_jax, corpus, draw, jax_flat,  # noqa: E402,F401
                                samplers)
from torch_bert_rerankers_util import bert_batch, load_port, reranker_pair  # noqa: E402

BASE_TOL = 1e-6
SCORE_TOL = 1e-5
INT8_TOL = 1e-4
SERVE_TOL = 1e-4


def test_new_lora_model_scores_as_its_base():
    """The JAX suite's ``test_lora_starts_at_pretrained_and_adds_adapters``:
    the adapters sit at the standard sites with flax's names and shapes, the
    up-projection starts at zero (the port's own init too), and the scores
    equal the base model's."""
    jax_base, port_base = reranker_pair("BERTMaxP", {})
    jax_lora, port_lora = reranker_pair("BERTMaxP", {"lora": 4})
    batch = bert_batch(3, 3, 64, qlen=5, seed=11, vocab=5000)
    p_base = jax_base.init_params(jax.random.PRNGKey(0), batch)
    p_lora = jax_lora.init_params(jax.random.PRNGKey(0), batch)
    base = load_port(port_base, flatten_params(p_base))
    lora = load_port(port_lora, flatten_params(p_lora))
    keys = set(flax_flat_params(lora)) - set(flax_flat_params(base))
    assert keys == {f"params/bert/layer_{i}/attention/{site}_lora/{leaf}/kernel"
                    for i in range(2) for site in ("query", "value") for leaf in ("down", "up")}
    assert flax_flat_params(lora)["params/bert/layer_0/attention/query_lora/down/kernel"].shape == (64, 4)
    with torch.inference_mode():
        s_base, s_lora = port_base.test(batch, "cpu").numpy(), port_lora.test(batch, "cpu").numpy()
    assert_within(s_lora, s_base, BASE_TOL, "a new LoRA model against its base")
    assert_within(s_lora, np.asarray(jax_lora.test(p_lora, batch)), SCORE_TOL, "a new LoRA model against JAX")

    init = flax_flat_params(port_lora.init_params(5))
    down, up = (init[f"params/bert/layer_1/attention/value_lora/{leaf}/kernel"] for leaf in ("down", "up"))
    assert not up.any() and 0.015 < down.std() < 0.025  # up zeros, down N(0, 0.02)
    adapters = [m for m in port_lora.model.modules() if isinstance(m, LoRAAdapter)]
    assert len(adapters) == 4 and all(a.scale == 16.0 / 4 for a in adapters)


@pytest.mark.parametrize("options", [{"lora": 4}, {"lora": 2, "loraalpha": 4.0}, {"lora": 4, "aggregation": "avg"}],
                         ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_lora_scores_match_jax(options):
    """Non-zero adapters carried from JAX: ``test`` and a training forward."""
    jax_rr, port_rr = reranker_pair("BERTMaxP", dict(options, hidden_dropout_prob=0.0))
    batch = bert_batch(3, 3, 64, qlen=5, seed=13, vocab=5000)
    params = with_adapters(jax_rr.init_params(jax.random.PRNGKey(2), batch))
    model = load_port(port_rr, flatten_params(params))
    want = np.asarray(jax_rr.test(params, batch))
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
        model.train()
        trained = port_rr._score_doc(*(torch.from_numpy(batch[k]) for k in ("pos_bert_input", "pos_mask", "pos_seg")),
                                     dropout_seed=3).numpy()
    assert_within(got, want, SCORE_TOL, f"LoRA BERTMaxP {options}")
    assert_within(trained, want, SCORE_TOL, f"LoRA BERTMaxP {options}, training forward with dropout 0")


def test_lora_training_matches_jax(corpus):
    """The trainable set is JAX's (the adapters and the head; the base encoder
    frozen), the gradients of step 1 and 3 Adam steps agree, and the frozen
    base stays bit-identical (``check_training_matches_jax``)."""
    jax_rr, port_rr = bert_pair(corpus, lora=4, trainer={"batch": 4, "lr": 1e-3, "bertlr": 1e-3})
    assert not port_rr.trainable(("params", "bert", "layer_0", "attention", "query", "kernel"), None)
    assert port_rr.trainable(("params", "bert", "layer_0", "attention", "query_lora", "down", "kernel"), None)
    assert port_rr.trainable(("params", "classifier", "kernel"), None)
    flat = flax_flat_params(port_rr.init_params(0))
    trainable = {k for k in flat if port_rr.trainable(tuple(k.split("/")), flat[k])}
    assert trainable == {k for k in flat if jax_rr.trainable(tuple(k.split("/")), flat[k])}
    assert trainable == {k for k in flat if "_lora/" in k or k.startswith("params/classifier/")}
    model = port_rr.build_train_model()
    optimizer = port_rr.trainer.make_optimizer(port_rr, model)
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    assert {n for n, p in model.named_parameters() if id(p) in held} == {
        n for n, p in model.named_parameters() if "_lora." in n or n.startswith("classifier.")}
    check_training_matches_jax(corpus, jax_rr, port_rr)


def test_lora_dev_best_bytes_cross_both_trainers(corpus, tmp_path):
    """A LoRA dev.best holds the adapters and the head, the frozen base empty,
    byte for byte as the JAX trainer writes it; the port reads JAX's and JAX
    reads the port's."""
    jax_rr, port_rr = bert_pair(corpus, lora=2)
    samples = draw(samplers(corpus, (jax_rr, port_rr), "pred")[0], 6)
    batch = collate(samples, ARRAY_KEYS)
    params = with_adapters(jax_rr.init_params(jax.random.PRNGKey(5), jax_collate(samples, ARRAY_KEYS)))
    jax_rr.trainer.save_checkpoint(tmp_path / "jax" / "dev.best", params, {}, jax_rr)
    flat = load_params(tmp_path / "jax" / "dev.best")
    assert {k for k, v in flat.items() if v.size} == {k for k in flat if "_lora/" in k or "classifier" in k}

    model = port_rr.init_params(9)  # the frozen base keeps its own values, as JAX's template does
    port_rr.trainer.load_checkpoint(tmp_path / "jax" / "dev.best", model, None, port_rr)
    port_rr.trainer.save_checkpoint(tmp_path / "port" / "dev.best", model, None, port_rr)
    assert (tmp_path / "port" / "dev.best.params").read_bytes() == (tmp_path / "jax" / "dev.best.params").read_bytes()
    full = sum(v.size for v in flax_flat_params(model).values())
    assert (tmp_path / "port" / "dev.best.params").stat().st_size < 0.25 * 4 * full

    template = jax_rr.init_params(jax.random.PRNGKey(5), jax_collate(samples, ARRAY_KEYS))
    loaded, _ = jax_rr.trainer.load_checkpoint(tmp_path / "port" / "dev.best", template, reranker=jax_rr)
    model.load_state_dict(port_rr.state_dict_from_params(jax_flat(template), model))  # JAX's frozen base, then
    port_rr.trainer.load_checkpoint(tmp_path / "port" / "dev.best", model, None, port_rr)  # the file's adapters
    with torch.no_grad():
        got = port_rr.test(batch, torch.device("cpu")).numpy()
    assert_within(got, np.asarray(jax_rr.test(loaded, batch)), SCORE_TOL, "the port's LoRA dev.best scored by JAX")


def test_lora_int8_matches_jax():
    """``quantize=int8`` with LoRA (the JAX suite's ``test_lora_int8_inference_composes``):
    the adapters in f32 beside the int8 projections, non-zero, with the stats
    JAX calibrated."""
    jax_rr, port_rr = reranker_pair("BERTMaxP", {"lora": 2, "quantize": "int8"}, numpassages=4)
    batch = bert_batch(3, 4, 64, qlen=5, seed=19, vocab=5000)
    params = with_adapters(jax_rr.init_params(jax.random.PRNGKey(9), batch))
    jax_rr.prepare_inference(params, batch)
    variables = jax_rr.inference_variables(params)
    model = load_port(port_rr, flatten_params(variables))
    assert model.bert.layer_0.attention.query_lora.up.weight.abs().max() > 0
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
    assert np.isfinite(got).all()
    assert_within(got, np.asarray(jax_rr.test(variables, batch)), INT8_TOL, "LoRA + int8 BERTMaxP")


def write_bert_checkpoint(directory, seed=0):
    """A tiny ``BertModel`` with seeded random weights, saved by ``transformers``."""
    from transformers import BertConfig as HFBertConfig
    from transformers import BertModel

    torch.manual_seed(seed)
    BertModel(HFBertConfig(**TINY_HF)).eval().save_pretrained(str(directory))
    return str(directory)


def test_reranking_service_serves_a_lora_dev_best(tmpdir_as_cache, torch_cache, tmp_path):
    """A LoRA dev.best (adapters and head, the base empty) over a pretrained
    checkpoint directory: both packages' ``RerankingService`` fill the frozen
    base from the checkpoint and rank alike."""
    pretrained = write_bert_checkpoint(tmp_path / "bert")
    coll = {"name": "dummy"}
    config = {"pretrained": pretrained, "lora": 2,
              "extractor": dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, index={"collection": coll})}
    jax_rr = JaxReranker.create("BERTMaxP", json.loads(json.dumps(config)))
    shape = (1, EXTRACTOR_TINY["numpassages"], EXTRACTOR_TINY["maxseqlen"])
    example = {key: np.zeros(shape, np.int64) for key in ("pos_bert_input", "pos_mask", "pos_seg")}
    params = with_adapters(jax_rr.init_params(jax.random.PRNGKey(1), example), shift=0.05)
    ckpt = tmp_path / "lora" / "dev.best"
    jax_rr.trainer.save_checkpoint(ckpt, params, {}, jax_rr)
    jax_svc = JaxRerankingService(JaxIndex.create("tpu", {"collection": coll}), jax_rr, ckpt, topn=3)
    port_svc = RerankingService(TorchIndex.create("tpu", {"collection": coll}),
                                TorchReranker.create("BERTMaxP", json.loads(json.dumps(config))), ckpt, topn=3,
                                device="cpu")
    queries = ["distant galaxies telescope", "telescope observed whales"]
    for port_hits, jax_hits in zip(port_svc.search(queries, k=3), jax_svc.search(queries, k=3)):
        assert [d for d, _ in port_hits] == [d for d, _ in jax_hits]
        assert_within([s for _, s in port_hits], [s for _, s in jax_hits], SERVE_TOL, "LoRA dev.best served")
    base = port_svc.reranker.model.bert.layer_0.attention.query.weight
    assert torch.equal(base, port_svc.reranker._pretrained_state["layer_0.attention.query.weight"])
