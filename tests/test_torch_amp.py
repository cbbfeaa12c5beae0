"""``trainer.amp`` in the PyTorch port against the JAX trainer's, on the CPU.

The JAX trainer casts every f32 leaf of the parameter tree to bf16 before a
forward (``jax_trainer.py:438-465`` for training, ``_amp_pred_params`` for
predictions) and differentiates through the cast. ``bf16_tree`` below is that
cast; the port's counterpart is ``trainer/amp.py``'s ``bf16_params``.

Tolerances (both sides compute in f32 on the same bf16-rounded weights, with
bf16 arithmetic in the same places):
- BERT-family ``amp`` scores: 1e-5 (measured within 3e-7: f32 sums in other
  orders), against an ``amp`` vs f32 gap above 1e-3 at these shapes (checked).
- KNRM ``amp`` scores: 2e-4, K1's tolerance (``tests/test_torch_knrm.py``):
  the sigma = 0.001 exact-match kernel turns a bf16 norm an ulp apart into a
  visible change.
- ``amp=train`` step 1: the loss 1e-5 relative; each gradient tensor within
  ``AMP_GRAD_TOL`` of its largest entry: both round each use's gradient to
  bf16 and sum the uses in bf16, so a gradient a rounding apart in f32 can
  land one bf16 step (2^-8) apart. KNRM's exact-match kernel (sigma 0.001)
  is left out of the mus and sigmas, as in ``tests/test_torch_trainer.py``:
  its gradient is rounding. A tensor whose gradient is below 1e-3 of the
  model's largest entry (the attention key bias: softmax is invariant to it)
  is held against that floor, as ``chip_smoke.py``'s step parity does. The
  embedding tables' gradients within ``EMBED_GRAD_TOL`` (2^-4): each is a
  scatter-add in bf16 over every token of the batch, rounded after each add
  in an order each package picks ([PAD], [CLS] and [SEP] rows take dozens).
- JAX's trainer runs its step compiled, and XLA may keep bf16 intermediates
  in f32 (``xla_allow_excess_precision``): the compiled function differs from
  the cast tree evaluated op by op by up to 5e-4 on tiny BERT-MaxP scores and
  0.5 on a KNRM score (the exact-match kernel). The port computes the cast
  tree op by op, so it is held to JAX's op-by-op evaluation: gradients from
  an unjitted ``value_and_grad``, predictions with ``trainer.eager``.
- int8 with ``amp=pred``: 1e-4, the int8 encoder tolerance
  (``tests/test_torch_int8.py``), with the stats JAX calibrated.
- K1's plain version on bf16-normalised rows against the Pallas kernel in
  interpret mode: 2e-4 on unpadded docs, as at f32, for the ten RBF kernels;
  ``EXACT_TOL`` 1e-3 for the exact-match kernel. A bf16-normalised row's
  norm is 1 only within bf16 rounding, so a token's similarity with itself
  sits on the slope of the sigma = 0.001 kernel, not at its flat peak as in
  f32, where an f32 rounding of the dot product moves the kernel by 1/sigma
  times as much.
"""


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

from capreolus_tpu.ops.simmat import knrm_simmat_pool as jax_knrm_simmat_pool  # noqa: E402
from capreolus_tpu.reranker.common import knrm_pool as jax_knrm_pool  # noqa: E402
from capreolus_tpu.reranker.common import similarity_matrix as jax_similarity_matrix  # noqa: E402
from capreolus_tpu.reranker.knrm import KNRMModel as JaxKNRMModel  # noqa: E402
from capreolus_tpu.trainer import Trainer as JaxTrainerBase  # noqa: E402
from capreolus_tpu.trainer.jax_trainer import collate as jax_collate  # noqa: E402
from capreolus_tpu_torch.convert import flax_flat_params, flax_leaves, knrm_state_dict  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.ops import simmat  # noqa: E402
from capreolus_tpu_torch.reranker.bert.encoder import BertSelfAttention  # noqa: E402
from capreolus_tpu_torch.reranker.common import KNRM_MUS, KNRM_SIGMAS  # noqa: E402
from capreolus_tpu_torch.reranker.knrm import KNRMModel  # noqa: E402
from capreolus_tpu_torch.trainer import Trainer as TorchTrainerBase  # noqa: E402
from capreolus_tpu_torch.trainer.amp import amp_mode, bf16_params  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from test_torch_bert import assert_within, with_adapters  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_knrm import SHAPES, TOL, flatten_params, make_inputs  # noqa: E402
from test_torch_trainer import (GRAD_FLOOR, STEP_TOL, _train, bert_pair, carry_over, corpus, draw,  # noqa: E402,F401
                                jax_flat, knrm_pair, make_rerankers, samplers, steps)
from torch_bert_rerankers_util import bert_batch, load_port, reranker_pair  # noqa: E402

SCORE_TOL = 1e-5
KNRM_TOL = TOL
AMP_GRAD_TOL = 2 ** -8
EMBED_GRAD_TOL = 2 ** -4
GRAD_NOISE_SHARE = 1e-3  # a tensor whose largest gradient entry is below this share of the model's is rounding
EXACT_TOL = 1e-3
EXACT = KNRM_SIGMAS.index(0.001)  # the exact-match kernel
INT8_TOL = 1e-4
AMP_GAP = 1e-3  # amp scores differ from f32 by more than this (the rounding is applied)


def bf16_tree(params):
    """The JAX trainer's amp cast of a parameter tree."""
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, params)


# ---------------------------------------------------------------- amp=pred forwards
BERT_MODELS = {
    "BERTMaxP": ("BERTMaxP", {}),
    "BERTMaxP-lora": ("BERTMaxP", {"lora": 4}),
    "parade": ("parade", {}),
    "CEDRKNRM": ("CEDRKNRM", {"simmat_layers": "0..2,1"}),
    "birch": ("birch", {"finetune": True}),
    "moe": ("BERTMaxP", {"moeexperts": 2}),
}


@pytest.mark.parametrize("model", sorted(BERT_MODELS))
def test_bert_rerankers_amp_forward_matches_jax(model):
    name, options = BERT_MODELS[model]
    jax_rr, port_rr = reranker_pair(name, options)
    batch = bert_batch(3, 3, 64, qlen=5, seed=11, vocab=5000)
    params = jax_rr.init_params(jax.random.PRNGKey(7), batch)
    want32 = np.asarray(jax_rr.test(params, batch))
    want = np.asarray(jax_rr.test(bf16_tree(params), batch))
    port = load_port(port_rr, flatten_params(params))
    with torch.inference_mode(), bf16_params(port):
        got = port_rr.test(batch, "cpu").numpy()
    with torch.inference_mode():
        got32 = port_rr.test(batch, "cpu").numpy()  # the f32 weights are back after the block
    assert_within(got, want, SCORE_TOL, f"{model} amp forward")
    assert_within(got32, want32, 1e-4, f"{model} f32 forward after the amp block")
    assert np.abs(want - want32).max() > AMP_GAP, "amp scores equal the f32 scores: nothing was rounded"


@pytest.mark.parametrize("frozen", [True, False])
def test_knrm_amp_forward_matches_jax(frozen):
    options = {"gradkernels": not frozen, "singlefc": True, "scoretanh": False, "finetune": False}
    b, q, d, e = SHAPES["serving"]
    emb, qt, dt = make_inputs((b, q, 200, e), seed=5, doc_pads=True)
    jax_model = JaxKNRMModel(embedding_init=emb, **options)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(qt), jnp.asarray(dt), None)
    want = np.asarray(jax_model.apply(bf16_tree(params), jnp.asarray(qt), jnp.asarray(dt), None))
    want32 = np.asarray(jax_model.apply(params, jnp.asarray(qt), jnp.asarray(dt), None))
    port = KNRMModel(emb, **options)
    port.load_state_dict(knrm_state_dict(flatten_params(params)))
    with torch.no_grad(), bf16_params(port.eval()):
        assert port.embedding.dtype == torch.bfloat16 and port.mus.dtype == torch.float32
        got = port(torch.from_numpy(qt).long(), torch.from_numpy(dt).long()).numpy()
    assert port.embedding.dtype == torch.float32 and isinstance(port.embedding, torch.nn.Parameter)
    np.testing.assert_allclose(got, want, rtol=KNRM_TOL, atol=KNRM_TOL)
    assert np.abs(want - want32).max() > AMP_GAP


def test_colbert_amp_forward_matches_jax(corpus):
    cfg = {"pretrained": "tiny", "allowrandominit": True, "dim": 8,
           "extractor": {"maxqlen": 8, "maxdoclen": 32, "tokenizer": {"pretrained": "definitely-not-a-real-model-xyz"}}}
    jax_rr, port_rr = make_rerankers(corpus, "colbert", cfg)
    samples = draw(samplers(corpus, (jax_rr, port_rr))[0], 6)
    batch = collate(samples, ARRAY_KEYS)
    params = carry_over(jax_rr, port_rr, samples)
    want = np.asarray(jax_rr.test(bf16_tree(params), batch))
    model = port_rr.build_model().eval()
    with torch.no_grad(), bf16_params(model):
        got = port_rr.test(batch, torch.device("cpu")).numpy()
    assert_within(got, want, SCORE_TOL, "ColBERT amp forward")
    assert np.abs(want - np.asarray(jax_rr.test(params, batch))).max() > 1e-4


def test_attention_inputs_stay_f32_under_amp(monkeypatch):
    """No amp mode hands attention bf16 inputs: q, k and v come out of f32
    Dense layers on rounded weights, in JAX and in the port, so K2 runs f32
    under every amp mode."""
    from capreolus_tpu.reranker.bert import encoder as jax_encoder

    seen = []
    real = jax_encoder.multihead_attention

    def record(q, k, v, *args, **kwargs):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, *args, **kwargs)

    monkeypatch.setattr(jax_encoder, "multihead_attention", record)
    jax_rr, port_rr = reranker_pair("BERTMaxP", {"lora": 2})
    batch = bert_batch(2, 2, 64, qlen=5, seed=12, vocab=5000)
    params = jax_rr.init_params(jax.random.PRNGKey(1), batch)
    seen.clear()
    jax_rr.test(bf16_tree(params), batch)
    assert seen and all(d == jnp.float32 for dtypes in seen for d in dtypes), seen
    port = load_port(port_rr, flatten_params(params))
    port_seen = []
    hooks = [m.register_forward_hook(lambda mod, args, out: port_seen.extend(t.dtype for t in mod.heads(args[0])))
             for m in port.modules() if isinstance(m, BertSelfAttention)]
    with torch.inference_mode(), bf16_params(port):
        port_rr.test(batch, "cpu")
    for h in hooks:
        h.remove()
    assert port_seen and set(port_seen) == {torch.float32}


# ---------------------------------------------------------------- K1 under amp
def test_k1_plain_on_bf16_rows_matches_pallas_kernel():
    """A frozen KNRM under amp on JAX's accelerator path feeds its Pallas
    kernel bf16 normalised rows; the port's K1 gets the same rows widened to
    f32 (exact), so its plain version is held to the kernel as at f32, on
    unpadded docs."""
    emb, qt, dt = make_inputs(SHAPES["serving"], seed=1, doc_pads=False)
    mus = jnp.asarray(KNRM_MUS, jnp.float32).astype(jnp.bfloat16)
    sigmas = jnp.asarray(KNRM_SIGMAS, jnp.float32).astype(jnp.bfloat16)
    want = np.asarray(jax_knrm_simmat_pool(jnp.asarray(emb).astype(jnp.bfloat16), jnp.asarray(qt), jnp.asarray(dt),
                                           mus, sigmas, use_pallas=True, interpret=True))
    args = simmat.knrm_inputs(torch.from_numpy(emb).bfloat16(), torch.from_numpy(qt), torch.from_numpy(dt),
                              torch.from_numpy(np.asarray(mus.astype(jnp.float32))),
                              torch.from_numpy(np.asarray(sigmas.astype(jnp.float32))))
    assert args[0].dtype == args[1].dtype == torch.float32
    assert torch.equal(args[0], args[0].bfloat16().float())  # bf16 values, widened exactly
    got = simmat.knrm_pool(*args).numpy()
    rbf = [k for k in range(len(KNRM_MUS)) if k != EXACT]
    np.testing.assert_allclose(got[:, rbf], want[:, rbf], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[:, EXACT], want[:, EXACT], rtol=EXACT_TOL, atol=EXACT_TOL)
    # the gap to JAX's CPU path, which normalises after an f32 dot product (ROADMAP's recorded difference)
    xla = np.asarray(jax_knrm_pool(jax_similarity_matrix(jnp.asarray(emb).astype(jnp.bfloat16), qt, dt), mus, sigmas))
    print(f"K1 path under amp vs JAX's CPU path: max |gap| {np.abs(got - xla).max():.4g} "
          f"(features up to {np.abs(xla).max():.4g})")


# ---------------------------------------------------------------- amp=train
def jax_amp_grads(jax_rr, params, batch):
    """The JAX trainer's amp loss of one micro-batch and its gradient."""
    loss_fn = jax_rr.trainer._loss_fn()
    kwargs = {"rngs": {"dropout": jax.random.PRNGKey(0)}} if jax_rr.accepts_rngs else {}

    def loss(p, b):
        pos, neg = jax_rr.score(bf16_tree(p), b, **kwargs)
        return loss_fn([pos.astype(jnp.float32), neg.astype(jnp.float32)])

    value, grads = jax.value_and_grad(loss)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), jax_flat(grads)


def port_amp_grads(port_rr, batch):
    model = port_rr.build_train_model()
    model.zero_grad(set_to_none=True)
    port_rr.trainer.make_optimizer(port_rr, model)  # freezes what the trainer freezes
    with bf16_params(model):
        loss = port_rr.trainer.compute_loss(port_rr, batch, torch.device("cpu"), dropout_seed=0)
        loss.backward()
    names = dict(model.named_parameters())
    return float(loss.detach()), {key: to_flax(names[n].grad).numpy().copy()
                                  for key, n, to_flax, _, _ in flax_leaves(model) if names[n].grad is not None}


AMP_TRAIN = {"knrm": {}, "knrm-frozen": {"gradkernels": False}, "bert": {}, "bert-lora": {"lora": 4}}


@pytest.mark.parametrize("case", sorted(AMP_TRAIN))
def test_amp_train_step_matches_jax(corpus, case):
    """Step 1 under amp=train from the JAX init: the loss and the gradients of
    the trainable weights against JAX's, then the port's ``train_step``
    against the JAX trainer's optimizer applied to JAX's gradients: the loss,
    the weights where |g| is above the floor, the frozen weights unmoved and
    the f32 weights moved (not rounded to bf16)."""
    import optax

    trainer = {"amp": "train", "batch": 4}
    if case.startswith("knrm"):
        jax_rr, port_rr = knrm_pair(corpus, trainer=trainer, **AMP_TRAIN[case])
    else:
        jax_rr, port_rr = bert_pair(corpus, trainer=trainer, **AMP_TRAIN[case])
    samples = draw(samplers(corpus, (jax_rr, port_rr))[0], 8)
    params = carry_over(jax_rr, port_rr, samples[:4])
    init = jax_flat(params)
    batch = steps(samples, 1, 4)[0]
    micro = {k: v[0] for k, v in batch.items()}
    j_loss, j_grads = jax_amp_grads(jax_rr, params, micro)
    p_loss, p_grads = port_amp_grads(port_rr, micro)
    assert_within(p_loss, j_loss, SCORE_TOL, f"{case}: amp step-1 loss")
    assert set(p_grads) == {k for k in init if port_rr.trainable(tuple(k.split("/")), init[k])}
    floor = GRAD_NOISE_SHARE * max(float(np.abs(g).max()) for g in j_grads.values())
    worst = {}
    for key, g in p_grads.items():
        diff = np.abs(g - j_grads[key])
        if key.endswith(("mus", "sigmas")):
            diff[EXACT] = 0.0
        err = float(diff.max()) / max(float(np.abs(j_grads[key]).max()), floor)
        tol = EMBED_GRAD_TOL if key.endswith("_embeddings") else AMP_GRAD_TOL
        worst[key] = err
        assert err <= tol, (key, err, tol)
    print(f"{case}: largest gradient errors {sorted(worst.items(), key=lambda kv: -kv[1])[:3]}")
    f32_loss = float(jax_rr.trainer._loss_fn()([np.asarray(x) for x in jax_rr.score(params, micro)]))
    assert abs(f32_loss - j_loss) > 1e-6, "the amp loss equals the f32 loss: nothing was rounded"

    tx = jax_rr.trainer._make_optimizer(jax_rr, params)
    tree_g = jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(j_grads["/".join(str(getattr(p, "key", p)) for p in path)]), params)
    updates, _ = tx.update(tree_g, tx.init(params), params)
    want = jax_flat(optax.apply_updates(params, updates))
    pt = port_rr.trainer
    model = port_rr.build_train_model()
    optimizer = pt.make_optimizer(port_rr, model)
    pl = float(pt.train_step(port_rr, model, optimizer, batch, 0, pt.step_seed(0, 0)))
    assert_within(pl, j_loss, SCORE_TOL, f"{case}: the port's amp train_step loss")
    got = flax_flat_params(model)
    for key in init:
        if key not in p_grads:
            np.testing.assert_array_equal(got[key], init[key], err_msg=f"frozen {key} moved")
            continue
        lr = pt.config["bertlr"] if "bert" in key else pt.config["lr"]
        mask = np.abs(j_grads[key]) > max(GRAD_FLOOR, worst[key] * max(float(np.abs(j_grads[key]).max()), floor))
        if key.endswith(("mus", "sigmas")):
            mask[EXACT] = False
        if mask.any():
            assert_within(got[key][mask] / lr, want[key][mask] / lr, STEP_TOL, f"{case}: {key} after one amp step")
    moved = [k for k in p_grads if not np.array_equal(got[k], init[k])]
    assert moved and any(not np.array_equal(got[k], got[k].astype(jnp.bfloat16).astype(np.float32)) for k in moved)


# ---------------------------------------------------------------- the trainer
@pytest.mark.parametrize("value,mode", [("none", "none"), ("False", "none"), (False, "none"), ("0", "none"),
                                        ("", "none"), ("train", "train"), ("pred", "pred"), ("both", "both"),
                                        ("True", "both"), (True, "both"), ("1", "both"), ("BOTH", "both")])
def test_amp_modes_as_jax(value, mode):
    """The JAX trainer's mode parsing (``_amp_mode``), string for string."""
    jt = JaxTrainerBase.create("jax", {"amp": value})
    assert amp_mode(value) == jt._amp_mode() == mode
    assert TorchTrainerBase.create("jax", {"amp": value}).amp_pred() == (mode in ("pred", "both"))


def test_amp_string_modes(corpus, tmp_path):
    """JAX's ``test_amp_string_modes`` on the port: amp=both trains BERT-MaxP
    to a finite MAP, and a misspelt mode raises."""
    _, port_rr = bert_pair(corpus, trainer={"niters": 1, "itersize": 4, "batch": 2, "validatefreq": 1,
                                            "amp": "both"})
    metrics, _, _ = _train(port_rr, corpus, tmp_path)
    assert np.isfinite(metrics["map"])
    with pytest.raises(ConfigError, match="amp must be"):
        amp_mode("ture")


@pytest.mark.parametrize("amp", ["pred", "none"])
def test_amp_pred_predictions_match_jax(corpus, amp):
    """The trainer's predictions under amp=pred (and none) from the JAX init,
    LoRA adapters non-zero, against the JAX trainer's, and the f32 weights
    untouched."""
    trainer = {"amp": amp, "batch": 4, "evalbatch": 6, "eager": True}
    jax_rr, port_rr = bert_pair(corpus, trainer=trainer, lora=2)
    dev = samplers(corpus, (jax_rr, port_rr), "pred")
    params = with_adapters(jax_rr.init_params(jax.random.PRNGKey(0), jax_collate(draw(dev[0], 4), ARRAY_KEYS)))
    port_rr.init_params(1).load_state_dict(port_rr.state_dict_from_params(jax_flat(params)))
    want = jax_rr.trainer.predict(jax_rr, dev[0], params=params)
    port_rr.trainer.device = "cpu"
    port_rr.trainer._model = port_rr.build_train_model()
    before = {k: v.clone() for k, v in port_rr.trainer._model.state_dict().items()}
    got = port_rr.trainer.predict(port_rr, dev[1])
    for k, v in port_rr.trainer._model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert sorted(got) == sorted(want)
    keys = [(q, d) for q in sorted(want) for d in sorted(want[q])]
    assert_within([got[q][d] for q, d in keys], [want[q][d] for q, d in keys], SCORE_TOL, f"amp={amp} predictions")


@pytest.mark.parametrize("lora", [0, 2])
def test_int8_amp_forward_matches_jax(lora):
    """int8 under amp=pred as the JAX trainer computes it: calibrated on the f32
    weights, then the weights and GELU stats rounded to bf16 and the weights
    quantized in bf16 arithmetic, codes saturated at 127 as XLA converts
    (a bf16 quotient can round to 128). The stats JAX calibrated are carried
    over, as ``tests/test_torch_int8.py`` carries them: an int8 layer is a step
    function of its input."""
    from capreolus_tpu_torch.trainer.amp import round_int8_inference

    jax_rr, port_rr = reranker_pair("BERTMaxP", {"lora": lora, "quantize": "int8"}, numpassages=4)
    batch = bert_batch(3, 4, 64, qlen=5, seed=19, vocab=5000)
    params = with_adapters(jax_rr.init_params(jax.random.PRNGKey(9), batch))
    jax_rr.prepare_inference(params, batch)
    variables = jax_rr.inference_variables(params)
    want = np.asarray(jax_rr.test(bf16_tree(variables), batch))
    want32 = np.asarray(jax_rr.test(variables, batch))
    model = load_port(port_rr, flatten_params(variables))
    round_int8_inference(model)
    with torch.inference_mode(), bf16_params(model):
        got = port_rr.test(batch, "cpu").numpy()
    assert_within(got, want, INT8_TOL, f"int8 amp forward, lora {lora}")
    assert np.abs(want - want32).max() > AMP_GAP


def test_int8_amp_predict_rounds_the_inference_model(corpus):
    """The trainer's int8 predictions under amp=pred are the inference model's
    forward after ``round_int8_inference``, in ``bf16_params``: its own f32
    calibration, then the rounding; the training model keeps its f32 weights,
    and the next ``prepare_inference`` quantizes in f32 again."""
    from capreolus_tpu_torch.reranker.bert.encoder import Int8Linear
    from capreolus_tpu_torch.trainer.amp import round_int8_inference

    jax_rr, port_rr = bert_pair(corpus, trainer={"amp": "pred", "batch": 4, "evalbatch": 6}, quantize="int8", lora=2)
    dev = samplers(corpus, (jax_rr, port_rr), "pred")[1]
    port_rr.trainer.device = "cpu"
    port_rr.trainer._model = port_rr.init_params(3)
    before = {k: v.clone() for k, v in port_rr.trainer._model.state_dict().items()}
    got = port_rr.trainer.predict(port_rr, dev)
    for k, v in port_rr.trainer._model.state_dict().items():
        assert torch.equal(v, before[k]), k
    samples = list(iter(dev))
    port_rr.prepare_inference(collate(samples[:6], ARRAY_KEYS), "cpu")
    assert {m.quant_dtype for m in port_rr.model.modules() if isinstance(m, Int8Linear)} == {torch.float32}
    round_int8_inference(port_rr.model)
    with torch.no_grad(), bf16_params(port_rr.model):
        want = np.concatenate([port_rr.test(collate(samples[i:i + 6], ARRAY_KEYS), "cpu").numpy()
                               for i in range(0, len(samples), 6)])
    np.testing.assert_array_equal([got[s["qid"]][s["posdocid"]] for s in samples], want)
