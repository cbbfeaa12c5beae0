"""Helpers of the tests of PARADE, CEDR-KNRM, Birch and MoE-BERT in the port
(``tests/test_torch_parade.py``, ``test_torch_cedr.py``, ``test_torch_birch.py``,
``test_torch_moe.py``): a JAX reranker and the port's of one config, scored on
the same [B, P, L] batch from the JAX init carried across by ``convert.py``.

Tolerances:
- f32 ``test`` scores: 1e-4, as BERTMaxP's at the tiny config
  (``tests/test_torch_bert.py``).
- int8 ``test`` scores with the stats JAX calibrated: ``ENCODER_TOL`` 1e-4 of
  ``tests/test_torch_int8.py``.
- training: ``tests/test_torch_trainer.py``'s ``check_training_matches_jax``.
"""

import json

import jax
import numpy as np
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()

from capreolus_tpu.reranker import Reranker as JaxReranker  # noqa: E402
from capreolus_tpu_torch.convert import flax_flat_params  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER, assert_within, bert_batch  # noqa: E402
from test_torch_knrm import flatten_params  # noqa: E402

SCORE_TOL = 1e-4
INT8_TOL = 1e-4  # tests/test_torch_int8.py's ENCODER_TOL
TRAIN_EXTRACTOR = dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, numpassages=3)


def reranker_pair(name, options, numpassages=3):
    """(JAX reranker, port reranker) of one config over the dummy collection, tiny encoder."""
    cfg = dict({"pretrained": "tiny"}, **options)
    cfg["extractor"] = dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, numpassages=numpassages,
                            index={"collection": {"name": "dummy"}})
    return (JaxReranker.create(name, json.loads(json.dumps(cfg))),
            TorchReranker.create(name, json.loads(json.dumps(cfg))))


def load_port(port_rr, flat):
    model = port_rr.build_model()
    model.load_state_dict(port_rr.state_dict_from_params(flat))
    return model.eval()


def check_scores_match_jax(name, options, what, seed=11, key=7):
    """f32 ``test`` scores of a [3 docs, 3 passages, 64] batch, from the JAX
    init; the port's parameter keys (``flax_flat_params``) are the JAX tree's."""
    jax_rr, port_rr = reranker_pair(name, options)
    batch = bert_batch(3, 3, 64, qlen=5, seed=seed, vocab=5000)
    params = jax_rr.init_params(jax.random.PRNGKey(key), batch)
    want = np.asarray(jax_rr.test(params, batch))
    flat = flatten_params(params)
    model = load_port(port_rr, flat)
    assert set(flax_flat_params(model)) == set(flat)
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
    assert got.shape == (3,)
    assert_within(got, want, SCORE_TOL, what)
    return jax_rr, port_rr


def check_int8_scores_match_jax(name, options, what):
    """int8 ``test`` scores with the stats JAX calibrated on the batch (its
    ``quant_stats`` carried through ``convert``), on ``tests/test_torch_int8.py``'s
    BERTMaxP int8 batch: 3 docs of 4 passages, init key 9."""
    jax_rr, port_rr = reranker_pair(name, dict(options, quantize="int8"), numpassages=4)
    batch = bert_batch(3, 4, 64, qlen=5, seed=19, vocab=5000)
    params = jax_rr.init_params(jax.random.PRNGKey(9), batch)
    jax_rr.prepare_inference(params, batch)
    variables = jax_rr.inference_variables(params)
    want = np.asarray(jax_rr.test(variables, batch))
    model = load_port(port_rr, flatten_params(variables))
    stats = [n for n, _ in model.named_buffers() if n.endswith("gelu_amax")]
    assert stats and all(float(getattr(model.get_submodule(n.rsplit(".", 1)[0]), "gelu_amax").abs().max()) > 0
                         for n in stats)
    with torch.inference_mode():
        got = port_rr.test(batch, "cpu").numpy()
    assert_within(got, want, INT8_TOL, what)
    return model
