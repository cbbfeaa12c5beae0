"""PARADE (``parade`` / ``ptparade``) in the port against the JAX package on
the CPU: ``test`` scores for each aggregation, int8 scores with JAX's stats,
the training forward's loss, gradients and Adam steps from the JAX init
(dropout 0), and what the trainer makes of the aggregation layers.
Tolerances are those of ``tests/torch_bert_rerankers_util.py``."""

import jax
import numpy as np
import pytest
import torch

from capreolus_tpu_torch.convert import flax_flat_params
from capreolus_tpu_torch.reranker.bert_rerankers import PARADE_AGG_DROPOUT_SITE, ParadeModel
from test_torch_index import torch_cache  # noqa: F401
from test_torch_trainer import check_training_matches_jax, corpus, make_rerankers  # noqa: F401
from torch_bert_rerankers_util import (TRAIN_EXTRACTOR, assert_within, bert_batch, check_int8_scores_match_jax,
                                       check_scores_match_jax, reranker_pair)

torch.set_num_threads(2)
AMAX_TOL = 1e-2  # tests/test_torch_int8.py: calibrated stats, relative to each layer's largest


@pytest.mark.parametrize("aggregation", ["transformer", "maxp", "avg"])
def test_parade_scores_match_jax(aggregation):
    _, port_rr = check_scores_match_jax("parade", {"aggregation": aggregation}, f"PARADE {aggregation}")
    model = port_rr.model
    assert isinstance(model, ParadeModel)
    assert hasattr(model, "agg_layer_1") == (aggregation == "transformer")


def test_ptparade_is_parade():
    _, port_rr = check_scores_match_jax("ptparade", {}, "ptparade (transformer)", seed=12, key=3)
    assert port_rr.extractor.module_name == "pooledbertpassage"
    assert port_rr.model.passage_position_embeddings.shape == (4, 64)  # numpassages + 1


@pytest.mark.parametrize("aggregation", ["transformer", "avg"])
def test_parade_int8_scores_match_jax(aggregation):
    model = check_int8_scores_match_jax("parade", {"aggregation": aggregation}, f"PARADE int8 {aggregation}")
    if aggregation == "transformer":  # the aggregation layers are int8 with stats of their own
        assert model.agg_layer_0.gelu_amax.abs().max() > 0
        assert type(model.agg_layer_0.ffn_output).__name__ == "Int8Linear"


def test_parade_calibrates_its_aggregation_layers_as_jax():
    jax_rr, port_rr = reranker_pair("parade", {"quantize": "int8"}, numpassages=4)
    batch = bert_batch(3, 4, 64, qlen=5, seed=21, vocab=5000)
    params = jax_rr.init_params(jax.random.PRNGKey(4), batch)
    from torch_bert_rerankers_util import flatten_params, load_port

    model = load_port(port_rr, flatten_params(params))
    jax_rr.prepare_inference(params, batch)
    port_rr.prepare_inference(batch, "cpu")
    stats = jax_rr._quant_stats
    for name in ("agg_layer_0", "agg_layer_1", "bert/layer_0", "bert/layer_1"):
        want = np.asarray(stats[name.split("/")[0]][name.split("/")[1]]["gelu_amax"] if "/" in name
                          else stats[name]["gelu_amax"])
        got = model.get_submodule(name.replace("/", ".")).gelu_amax.numpy()
        assert (got > 0).all()
        assert_within(got / want.max(), want / want.max(), AMAX_TOL, f"calibrated gelu_amax of {name}")


@pytest.mark.parametrize("aggregation", ["transformer", "maxp", "avg"])
def test_parade_training_matches_jax(corpus, aggregation):
    jax_rr, port_rr = make_rerankers(corpus, "parade", {
        "pretrained": "tiny", "hidden_dropout_prob": 0.0, "aggregation": aggregation,
        "extractor": TRAIN_EXTRACTOR, "trainer": {"batch": 2, "lr": 1e-3, "bertlr": 1e-3, "itersize": 8}})
    check_training_matches_jax(corpus, jax_rr, port_rr)


def test_parade_aggregation_trains_at_lr(corpus):
    """The aggregation layers, passage embeddings and agg_cls have no "bert"
    in their JAX paths: the trainer puts them in the ``other`` group (``lr``)."""
    _, port_rr = make_rerankers(corpus, "parade", {"pretrained": "tiny", "extractor": TRAIN_EXTRACTOR})
    labels = port_rr.trainer.param_labels(port_rr, port_rr.init_params(0))
    for name, label in labels.items():
        want = "bert" if name.startswith("bert.") else "other"
        assert label == want, name
    assert labels["agg_layer_1.attention.query.weight"] == "other" and labels["agg_cls"] == "other"


def test_parade_aggregation_layers_draw_dropout_of_their_own(corpus):
    """A training forward seeds the aggregation layers' dropout at sites no
    encoder layer takes: their masks differ from encoder layers 0 and 1's."""
    from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

    seeds = {dropout_generator_seed(5, i + 1) for i in range(12)}
    agg = {dropout_generator_seed(5, PARADE_AGG_DROPOUT_SITE + i) for i in range(2)}
    assert not seeds & agg and len(agg) == 2
    _, port_rr = make_rerankers(corpus, "parade", {"pretrained": "tiny", "hidden_dropout_prob": 0.3,
                                                   "extractor": TRAIN_EXTRACTOR})
    model = port_rr.init_params(0)
    x = torch.randn(2, 4, 64)
    seen = []
    for name in ("bert.layer_0", "bert.layer_1", "agg_layer_0", "agg_layer_1"):
        layer = model.get_submodule(name)
        layer.register_forward_hook(lambda mod, args, out, name=name: seen.append((name, args[3])))
    batch = bert_batch(2, 3, 64, qlen=5, seed=3)
    with torch.no_grad():
        model(*(torch.from_numpy(batch[k]) for k in ("pos_bert_input", "pos_mask", "pos_seg")), dropout_seed=5)
    by_name = dict(seen)
    assert len(set(by_name.values())) == 4, by_name
    with torch.no_grad():  # the same seed draws the same masks; another seed others
        a = model.agg_layer_0(x, torch.ones(2, 4, dtype=torch.bool), False, by_name["agg_layer_0"])
        b = model.agg_layer_0(x, torch.ones(2, 4, dtype=torch.bool), False, by_name["agg_layer_0"])
        c = model.agg_layer_0(x, torch.ones(2, 4, dtype=torch.bool), False, by_name["bert.layer_0"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_parade_keys_round_trip_through_convert():
    jax_rr, port_rr = reranker_pair("parade", {})
    batch = bert_batch(2, 3, 64, qlen=5, seed=4)
    from torch_bert_rerankers_util import flatten_params, load_port

    flat = flatten_params(jax_rr.init_params(jax.random.PRNGKey(1), batch))
    got = flax_flat_params(load_port(port_rr, flat))
    assert list(got) and set(got) == set(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=key)
