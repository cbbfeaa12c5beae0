"""The retrieval rerankers of the PyTorch port (``biencoder``, ``unicoil``,
``splade``), ``trainer.loss=infonce`` and SPLADE's FLOPS regularizer against
the JAX package on the CPU, at tiny width (2 layers, hidden 64) from the JAX
init carried over, dropout off.

Tolerances:
- scores (``test`` and a training forward): 1e-5 relative (f32 sums of the
  tiny encoder in other orders, as ``tests/test_torch_colbert_train.py``).
- training: ``tests/test_torch_trainer.py``'s ``check_training_matches_jax``
  (step 1's gradients 1e-5 of each tensor's largest entry, 3 Adam steps on
  the same gradients 1e-4 of the learning rate, each trainer's own steps).
- each trainer's own steps (infonce, margin_mse, SPLADE with its
  regularizer): step 1's loss GRAD_TOL, later losses and the weights after
  them OWN_STEP_TOL of the rate.
- the MLM head read from a ``BertForMaskedLM`` directory: equal.
"""

import json

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

from capreolus_tpu.core import ConfigError as JaxConfigError  # noqa: E402
from capreolus_tpu.trainer.jax_trainer import collate as jax_collate  # noqa: E402
from capreolus_tpu_torch.convert import flax_flat_params  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from test_torch_bert import OFFLINE_TOKENIZER, assert_within  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import (GRAD_TOL, OWN_STEP_TOL, carry_over, check_training_matches_jax, corpus,  # noqa: E402,F401
                                draw, jax_flat, load_flat, make_rerankers, samplers, steps)

SCORE_TOL = 1e-5
RETRIEVERS = ("biencoder", "unicoil", "splade")


def retriever_config(name, **options):
    cfg = {"pretrained": "tiny", "allowrandominit": True, "hidden_dropout_prob": 0.0,
           "extractor": {"maxqlen": 8, "maxdoclen": 24, "tokenizer": OFFLINE_TOKENIZER}}
    if name == "splade":
        cfg["regweight"] = 0.0  # check_training_matches_jax holds the score-based loss; the regularizer has its own test
    cfg.update(options)
    return json.loads(json.dumps(cfg))


SPLADE_DECODER_BIAS = -3.0


def pair(corpus, name, **options):
    """(JAX, port) rerankers. SPLADE's JAX init gets a decoder bias of
    ``SPLADE_DECODER_BIAS``, carried over with the rest, so that its reps are
    sparse as a trained SPLADE's are: flax's random head puts log1p(relu(.))
    mass on half the 30,522 terms, and scores of ~1e2 (sums over the whole
    vocabulary) would hold a pairwise loss only to f32's relative accuracy of
    the scores, not of the loss."""
    jax_rr, port_rr = make_rerankers(corpus, name, retriever_config(name, **options))
    if name == "splade":
        init = jax_rr.init_params

        def init_params(rng, batch):
            params = init(rng, batch)
            decoder = params["params"]["mlm"]["decoder"]
            decoder["bias"] = jnp.full_like(decoder["bias"], SPLADE_DECODER_BIAS)
            return params

        jax_rr.init_params = init_params
    return jax_rr, port_rr


@pytest.mark.parametrize("name", RETRIEVERS)
def test_scores_match_jax(corpus, name):
    """``test`` (the prediction forward) and ``score`` (a training forward)
    from the JAX init."""
    jax_rr, port_rr = pair(corpus, name)
    samples = draw(samplers(corpus, (jax_rr, port_rr))[0], 6)
    batch = collate(samples, ARRAY_KEYS)
    params = carry_over(jax_rr, port_rr, samples, seed=3)
    model = port_rr.build_model()
    model.load_state_dict(port_rr.state_dict_from_params(jax_flat(params)))
    want = np.asarray(jax_rr.test(params, jax_collate(samples, ARRAY_KEYS)))
    with torch.no_grad():
        got = port_rr.test(batch, torch.device("cpu")).numpy()
        pos, neg = port_rr.score(batch, torch.device("cpu"), dropout_seed=4)
    assert_within(got, want, SCORE_TOL, f"{name} test scores")
    jpos, jneg = jax_rr.score(params, jax_collate(samples, ARRAY_KEYS), rngs={"dropout": jax.random.PRNGKey(0)})
    assert_within(pos.numpy(), np.asarray(jpos), SCORE_TOL, f"{name} training forward, positives")
    assert_within(neg.numpy(), np.asarray(jneg), SCORE_TOL, f"{name} training forward, negatives")


@pytest.mark.parametrize("name", RETRIEVERS)
def test_training_matches_jax(corpus, name):
    """The pooler is read by none of the three models: JAX's gradient of it
    is 0 and the port computes none."""
    jax_rr, port_rr = pair(corpus, name, trainer={"batch": 4})
    check_training_matches_jax(corpus, jax_rr, port_rr, own_steps=2,
                               unused=("params/bert/pooler/kernel", "params/bert/pooler/bias"))


def own_steps_match_jax(corpus, jax_rr, port_rr, sampler="triplet", n_steps=2, sampler_config=None):
    """Each trainer's own jitted / eager steps from one carried init: step 1's
    loss (the objective itself) at GRAD_TOL, step 2's (after one Adam step on
    each trainer's own gradients) at OWN_STEP_TOL. Returns the port's losses."""
    batch = port_rr.trainer.config["batch"]
    samples = draw(samplers(corpus, (jax_rr, port_rr), sampler, sampler_config)[0], n_steps * batch)
    params = carry_over(jax_rr, port_rr, samples[:batch])
    jt, pt = jax_rr.trainer, port_rr.trainer
    tx = jt._make_optimizer(jax_rr, params)
    train_step = jt._build_train_step(jax_rr, tx, jt._loss_fn())
    jparams, opt_state = jax.tree_util.tree_map(jnp.array, params), tx.init(params)
    model = port_rr.build_train_model()
    load_flat(port_rr, model, jax_flat(params))
    optimizer = pt.make_optimizer(port_rr, model)
    losses = []
    for i, b in enumerate(steps(samples, 1, batch)[:n_steps]):
        jparams, opt_state, j_loss = train_step(jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()},
                                                jax.random.PRNGKey(i))
        p_loss = float(pt.train_step(port_rr, model, optimizer, b, i, pt.step_seed(0, i)))
        assert_within(p_loss, float(j_loss), GRAD_TOL if i == 0 else OWN_STEP_TOL, f"step {i + 1} loss")
        losses.append(p_loss)
    return losses


def test_infonce_steps_match_jax(corpus):
    """``trainer.loss=infonce``: the in-batch [B, 2B] logit matrix (f32 ``q @
    pos.T`` with ``q @ neg.T`` appended, times ``scale``) against ``arange(B)``,
    each trainer's own steps."""
    jax_rr, port_rr = pair(corpus, "biencoder", trainer={"batch": 4, "loss": "infonce"})
    losses = own_steps_match_jax(corpus, jax_rr, port_rr)
    assert all(np.isfinite(losses))


def test_splade_regularizer_matches_jax(corpus):
    """The FLOPS penalty's value on one batch from the JAX init, and each
    trainer's own steps with it in the loss (regweight 0.01)."""
    jax_rr, port_rr = pair(corpus, "splade", regweight=0.01, trainer={"batch": 4})
    samples = draw(samplers(corpus, (jax_rr, port_rr))[0], 4)
    params = carry_over(jax_rr, port_rr, samples, seed=5)
    want = float(jax_rr.regularizer(params, jax_collate(samples, ARRAY_KEYS)))
    with torch.no_grad():
        got = float(port_rr.regularizer(collate(samples, ARRAY_KEYS), torch.device("cpu")))
    assert want > 0
    assert_within(got, want, SCORE_TOL, "SPLADE FLOPS regularizer")
    own_steps_match_jax(corpus, *pair(corpus, "splade", regweight=0.01, trainer={"batch": 4}))


def test_biencoder_margin_mse_distill_matches_jax(corpus, tmp_path):
    """The biencoder student under ``sampler.name=distill`` and
    ``loss=margin_mse`` (``tests/test_distill.py``): each trainer's own steps."""
    teacher = tmp_path / "teacher.run"
    with open(teacher, "wt") as f:
        for qid, docs in corpus["run"].items():
            for rank, (docid, score) in enumerate(docs.items(), start=1):
                f.write(f"{qid} Q0 {docid} {rank} {score * 0.5 + (rank % 3)} teacher\n")
    jax_rr, port_rr = pair(corpus, "biencoder", trainer={"batch": 4, "loss": "margin_mse"})
    own_steps_match_jax(corpus, jax_rr, port_rr, sampler="distill",
                        sampler_config={"teacherrunfile": str(teacher)})


def test_biencoder_encode_consistent_with_score(corpus):
    """``encode`` gives unit embeddings whose scaled diagonal similarity is
    the pairwise score (``tests/test_infonce.py``), and each site draws its
    own dropout."""
    _, port_rr = pair(corpus, "biencoder", hidden_dropout_prob=0.1)
    samples = draw(samplers(corpus, (port_rr, port_rr))[1], 4)
    batch = collate(samples, ARRAY_KEYS)
    port_rr.init_params(2)
    cpu = torch.device("cpu")
    with torch.no_grad():
        q, pos, neg, scale = port_rr.encode(batch, cpu)
        for e in (q, pos, neg):
            np.testing.assert_allclose(torch.linalg.vector_norm(e, dim=1).numpy(), 1.0, atol=1e-5)
        pos_s, neg_s = port_rr.score(batch, cpu)
        assert_within((scale * (q * pos).sum(1)).numpy(), pos_s.numpy(), SCORE_TOL, "encode vs score, pos")
        assert_within((scale * (q * neg).sum(1)).numpy(), neg_s.numpy(), SCORE_TOL, "encode vs score, neg")
        a, b = port_rr.encode(batch, cpu, dropout_seed=3), port_rr.encode(batch, cpu, dropout_seed=3)
        assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
        assert not torch.equal(a[0], q)


def _train_outcome(rr, corpus, tmp_path, sampler_name):
    """The exception type and message of training ``rr`` (None if it trains)."""
    registry = type(rr).__module__.split(".")[0]
    if registry == "capreolus_tpu":
        from capreolus_tpu.sampler import Sampler
    else:
        from capreolus_tpu_torch.sampler import Sampler
        rr.trainer.device = "cpu"
    sampler = Sampler.create(sampler_name)
    sampler.prepare(corpus["run"], corpus["qrels"], rr.extractor)
    dev = Sampler.create("pred")
    dev.prepare(corpus["run"], corpus["qrels"], rr.extractor)
    try:
        rr.trainer.train(rr, sampler, tmp_path / registry / "t", dev, tmp_path / registry / "d", corpus["qrels"],
                         metric="map")
    except (ConfigError, JaxConfigError) as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", ["knrm_has_no_encode", "pair_sampler", "softmaxloss"])
def test_infonce_refusals_match_jax(corpus, tmp_path, case):
    """``loss=infonce`` refuses a reranker without ``encode``, a pair stream
    and a ``softmaxloss`` override, with the JAX trainer's messages."""
    trainer = {"loss": "infonce", "niters": 1, "itersize": 8, "batch": 4}
    if case == "knrm_has_no_encode":
        rrs = make_rerankers(corpus, "KNRM", {"extractor": {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 16},
                                              "trainer": trainer})
        messages = [_train_outcome(rr, corpus, tmp_path, "triplet") for rr in rrs]
        assert "needs a reranker exposing embeddings (encode)" in messages[0]
    elif case == "pair_sampler":
        rrs = pair(corpus, "biencoder", trainer=trainer)
        messages = [_train_outcome(rr, corpus, tmp_path, "pair") for rr in rrs]
        assert "triplet-form stream" in messages[0]
    else:
        rrs = pair(corpus, "biencoder", trainer=dict(trainer, softmaxloss=True))
        messages = []
        for rr, error in zip(rrs, (JaxConfigError, ConfigError)):
            with pytest.raises(error, match="softmaxloss") as raised:
                rr.trainer._loss_fn()
            messages.append(str(raised.value))
    assert messages[1] == messages[0]


def test_load_pretrained_mlm_head_matches_jax(tmp_path):
    """The MLM head of a ``BertForMaskedLM`` directory that ``transformers``
    writes (seeded random weights): the transform, its LayerNorm, and the
    decoder tied to the word embeddings, equal to the JAX loader's (its flax
    kernels transposed); a directory without the head gives None in both."""
    from transformers import BertConfig as HFBertConfig
    from transformers import BertForMaskedLM, BertModel

    from capreolus_tpu.reranker.bert.encoder import load_pretrained_mlm_head as jax_load
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.reranker.splade import MlmHead, load_pretrained_mlm_head

    hf = HFBertConfig(vocab_size=96, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=32, max_position_embeddings=64)
    torch.manual_seed(11)
    model = BertForMaskedLM(hf).eval()
    with torch.no_grad():
        model.cls.predictions.bias.normal_()
        model.cls.predictions.transform.LayerNorm.weight.normal_()
    model.save_pretrained(str(tmp_path / "mlm"))
    got = load_pretrained_mlm_head(str(tmp_path / "mlm"), get_bert_config("tiny"))
    want = jax_load(str(tmp_path / "mlm"), None)
    for ours, (sub, leaf, transpose) in {
            "transform.weight": ("transform", "kernel", True), "transform.bias": ("transform", "bias", False),
            "transform_ln.weight": ("transform_ln", "scale", False), "transform_ln.bias": ("transform_ln", "bias", False),
            "decoder.weight": ("decoder", "kernel", True), "decoder.bias": ("decoder", "bias", False)}.items():
        value = got[ours].numpy()
        np.testing.assert_array_equal(value.T if transpose else value, want[sub][leaf], err_msg=ours)
    np.testing.assert_array_equal(got["decoder.weight"].numpy(),
                                  model.bert.embeddings.word_embeddings.weight.detach().numpy())
    head = MlmHead(16, 96)
    head.load_state_dict(got)
    BertModel(hf).save_pretrained(str(tmp_path / "plain"))
    assert load_pretrained_mlm_head(str(tmp_path / "plain"), None) is None


def test_splade_rep_chunks_give_the_unchunked_maximum(monkeypatch):
    """Outside training ``rep`` takes its max over positions a chunk at a
    time; the maximum equals the one-shot max under autograd."""
    import capreolus_tpu_torch.reranker.splade as sp
    from capreolus_tpu_torch.reranker.bert import get_bert_config

    torch.manual_seed(0)
    model = sp.SpladeModel(get_bert_config("tiny"), vocab_size=300)
    toks = torch.from_numpy(np.random.Generator(np.random.PCG64(1)).integers(0, 1000, size=(3, 20)))
    full = model.rep(toks).detach()
    monkeypatch.setattr(sp, "REP_LOGIT_ELEMENTS", 3 * 300 * 3)  # 3 positions a chunk
    with torch.no_grad():
        chunked = model.rep(toks)
    assert_within(chunked.numpy(), full.numpy(), SCORE_TOL, "chunked SPLADE rep")
