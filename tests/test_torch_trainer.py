"""The port's trainer against the JAX trainer on the CPU (``capreolus_tpu_torch/
trainer/``, ``sampler/``, the losses of ``reranker/common.py``, the models'
training forwards and ``utils/flax_msgpack.py``).

Inputs come from seeded numpy draws and one synthetic corpus; each test states
its tolerance. Where both packages start from the same weights (the JAX
init, carried over with ``state_dict_from_params``), the gradients of one
batch and the weights after 3 Adam steps must agree: Adam's first step is
about ``lr * sign(g)``, so a weight whose gradient is near 0 may step either
way on two implementations; weights are compared where every step's |g| is
above ``GRAD_FLOOR``.
"""

import json
from pathlib import Path

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

from capreolus_tpu.reranker import Reranker as JaxReranker  # noqa: E402
from capreolus_tpu.reranker.common import LOSS_FUNCTIONS as JAX_LOSSES  # noqa: E402
from capreolus_tpu.sampler import Sampler as JaxSampler  # noqa: E402
from capreolus_tpu.trainer import Trainer as JaxTrainerBase  # noqa: E402
from capreolus_tpu.trainer.jax_trainer import collate as jax_collate  # noqa: E402
from capreolus_tpu.trainer.jax_trainer import select_hard_negatives as jax_select_hard_negatives  # noqa: E402
from capreolus_tpu_torch.convert import flax_flat_params, load_params  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.reranker.common import KNRM_SIGMAS, LOSS_FUNCTIONS  # noqa: E402
from capreolus_tpu_torch.sampler import Sampler as TorchSampler  # noqa: E402
from capreolus_tpu_torch.trainer import Trainer as TorchTrainerBase  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from capreolus_tpu_torch.trainer.torch_trainer import select_hard_negatives  # noqa: E402
from capreolus_tpu_torch.utils import flax_msgpack  # noqa: E402
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER, assert_within  # noqa: E402
from test_torch_index import torch_cache, write_trec_corpus  # noqa: E402,F401

GRAD_TOL = 1e-5  # gradients of one batch from the same weights: f32 sums in other orders
STEP_TOL = 1e-4  # weights after 3 Adam steps on the same gradients, relative to lr: optax computes
# the bias correction 1 - 0.999^t in f32 (1.3e-5 from its exact value at t = 1), torch in f64
OWN_STEP_TOL = 1e-3  # losses of steps 2 and 3 and weights (/ lr) after 3 steps of each trainer on its own
# gradients: an Adam step of a weight whose |g| is within the gradients' rounding can flip (2 * lr)
GRAD_FLOOR = 1e-4  # below it Adam's first step, about lr * sign(g), may flip between implementations
LOSS_TOL = 1e-6  # the six losses on the same scores
MSGPACK_SCORE_TOL = 2e-4  # a dev.best scored by the other package

KNRM_EXTRACTOR = {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 24}
NUM_QUERIES, DOCS_PER_QUERY = 4, 12


# ---------------------------------------------------------------- fixtures
@pytest.fixture
def corpus(tmpdir_as_cache, torch_cache):
    """A 60-doc corpus, 4 queries of 12 candidates each with 3 relevant, the
    caches of both packages under the test's tmpdir."""
    docs = write_trec_corpus(tmpdir_as_cache / "corpus", num_docs=60, seed=5, min_len=20, max_len=60)
    rng = np.random.Generator(np.random.PCG64(3))
    ids = [d for d, _ in docs]
    run, qrels, topics = {}, {}, {}
    for q in range(NUM_QUERIES):
        qid = str(400 + q)
        cands = [ids[i] for i in rng.choice(len(ids), size=DOCS_PER_QUERY, replace=False)]
        run[qid] = {d: float(DOCS_PER_QUERY - i) for i, d in enumerate(cands)}
        qrels[qid] = {d: int(i % 4 == 0) for i, d in enumerate(cands)}
        topics[qid] = " ".join(docs[int(rng.integers(len(docs)))][1].split()[:3])
    return {"collection": {"name": "dummy", "path": str(tmpdir_as_cache / "corpus")}, "run": run,
            "qrels": qrels, "topics": topics, "docids": sorted({d for r in run.values() for d in r})}


def make_rerankers(corpus, name, options):
    """(JAX reranker, port reranker) of one config, their extractors preprocessed over the corpus's run."""
    options = json.loads(json.dumps(options))
    options.setdefault("extractor", {})["index"] = {"collection": corpus["collection"]}
    out = []
    for registry in (JaxReranker, TorchReranker):
        reranker = registry.create(name, json.loads(json.dumps(options)))
        reranker.extractor.preprocess(list(corpus["run"]), corpus["docids"], corpus["topics"])
        out.append(reranker)
    return out


def knrm_pair(corpus, **options):
    return make_rerankers(corpus, "KNRM", dict(options, extractor=dict(KNRM_EXTRACTOR)))


def bert_pair(corpus, **options):
    opts = {"pretrained": "tiny", "hidden_dropout_prob": 0.0,
            "extractor": dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER)}
    opts.update(options)
    return make_rerankers(corpus, "BERTMaxP", opts)


def samplers(corpus, rerankers, name="triplet", config=None):
    out = []
    for registry, reranker in zip((JaxSampler, TorchSampler), rerankers):
        sampler = registry.create(name, dict(config or {}))
        sampler.prepare(corpus["run"], corpus["qrels"], reranker.extractor)
        out.append(sampler)
    return out


def draw(sampler, n):
    it = iter(sampler)
    return [next(it) for _ in range(n)]


def jax_flat(params):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def carry_over(jax_rr, port_rr, samples, seed=0):
    """The JAX init of ``jax_rr`` loaded into ``port_rr``'s training model; returns the JAX params."""
    params = jax_rr.init_params(jax.random.PRNGKey(seed), jax_collate(samples, ARRAY_KEYS))
    model = port_rr.init_params(seed + 1)
    model.load_state_dict(port_rr.state_dict_from_params(jax_flat(params)))
    return params


def steps(samples, gradacc, batch):
    """[gradacc, batch, ...] batches of consecutive samples, as both producers build them."""
    need = gradacc * batch
    out = []
    for i in range(0, len(samples) - need + 1, need):
        b = jax_collate(samples[i:i + need], ARRAY_KEYS)
        out.append({k: v.reshape((gradacc, batch) + v.shape[1:]) for k, v in b.items()})
    return out


def jax_grads(jax_rr, params, batch):
    """The JAX trainer's loss of one micro-batch (its ``compute_loss``) and its
    gradient, jitted once per reranker."""
    fn = getattr(jax_rr, "_test_value_and_grad", None)
    if fn is None:
        trainer = jax_rr.trainer
        loss_fn = trainer._loss_fn()
        kwargs = {"rngs": {"dropout": jax.random.PRNGKey(0)}} if jax_rr.accepts_rngs else {}

        def loss(p, b):
            pos, neg = jax_rr.score(p, b, **kwargs)
            if trainer.config["loss"] == "crossentropy":
                return loss_fn(jnp.stack([neg, pos], axis=1).astype(jnp.float32), b["label"])
            return loss_fn([pos.astype(jnp.float32), neg.astype(jnp.float32)])

        fn = jax_rr._test_value_and_grad = jax.jit(jax.value_and_grad(loss))
    value, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), jax_flat(grads)


def port_grads(port_rr, batch):
    model = port_rr.build_train_model()
    model.zero_grad(set_to_none=True)
    port_rr.trainer.make_optimizer(port_rr, model)  # freezes what the trainer freezes
    loss = port_rr.trainer.compute_loss(port_rr, batch, torch.device("cpu"), dropout_seed=0)
    loss.backward()
    grads = {}
    names = dict(model.named_parameters())
    from capreolus_tpu_torch.convert import _flax_leaves

    for key, name, transposed in _flax_leaves(model):
        g = names[name].grad
        if g is not None:
            grads[key] = (g.T if transposed else g).numpy().copy()
    return float(loss.detach()), grads


# ---------------------------------------------------------------- losses
LOSS_CASES = {
    "pairwise_hinge_loss": lambda s, lab: ([s[:, 0], s[:, 1]],),
    "pair_hinge_loss": lambda s, lab: ([s[:, 0], s[:, 1]],),
    "pair_softmax_loss": lambda s, lab: ([s[:, 0], s[:, 1]],),
    "crossentropy": lambda s, lab: (s[:, :2], lab),
    "lce": lambda s, lab: (s, None),
    "margin_mse": lambda s, lab: (s[:, 0], s[:, 1], s[:, 2]),
    "infonce": lambda s, lab: (s, np.arange(s.shape[0]) % s.shape[1]),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    rng = np.random.Generator(np.random.PCG64(11))
    scores = rng.standard_normal((9, 5)).astype(np.float32) * 2
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 9)]
    args = LOSS_CASES[name](scores, labels)

    def conv(x, to):
        if isinstance(x, list):
            return [conv(v, to) for v in x]
        return None if x is None else to(x)

    want = float(JAX_LOSSES[name](*[conv(a, jnp.asarray) for a in args]))
    got = float(LOSS_FUNCTIONS[name](*[conv(a, torch.from_numpy) for a in args]))
    assert_within(got, want, LOSS_TOL, f"loss {name}")
    assert set(LOSS_FUNCTIONS) == set(JAX_LOSSES)


# ---------------------------------------------------------------- schedule
SCHEDULES = [
    {"warmupiters": 2},
    {"decaytype": "exponential", "decay": 0.5, "decayiters": 2},
    {"decaytype": "linear", "decay": 1.0},
    {"warmupiters": 1, "decaytype": "exponential", "decay": 0.8, "decayiters": 2, "gradacc": 2},
    {"warmupiters": 1, "decaytype": "linear", "decay": 0.3},
]


@pytest.mark.parametrize("options", SCHEDULES, ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_schedule_matches_optax(options):
    """Each step's learning rate, read from the JAX trainer's optax update of a
    unit gradient divided by the update of ``optax.adam`` at a constant unit
    rate (the same Adam arithmetic), against the port's schedule at the same
    step count: an off-by-one step moves a rate by more than 5% here."""
    import optax

    cfg = dict({"batch": 8, "itersize": 32, "niters": 4, "lr": 0.01}, **options)
    jt = JaxTrainerBase.create("jax", cfg)
    pt = TorchTrainerBase.create("jax", cfg)

    class AllTrainable:
        def trainable(self, path, value):
            return True

    params = {"dense": {"kernel": np.zeros((2,), np.float32)}}
    tx = jt._make_optimizer(AllTrainable(), params)
    state = tx.init(params)
    unit = optax.adam(1.0)
    unit_state = unit.init(params)
    ones = {"dense": {"kernel": np.ones((2,), np.float32)}}
    for step in range(4 * pt.steps_per_iter + 2):
        updates, state = tx.update(ones, state, params)
        unit_updates, unit_state = unit.update(ones, unit_state, params)
        want = float(updates["dense"]["kernel"][0]) / float(unit_updates["dense"]["kernel"][0])
        got = float(pt.learning_rate(cfg["lr"], step))
        assert got == pytest.approx(want, rel=1e-6), (step, got, want)


def test_loss_file_two_writer_detection(tmp_path):
    fn = tmp_path / "loss.txt"
    fn.write_text("0 1.0\n0 0.9\n")
    with pytest.raises(IOError, match="two processes"):
        TorchTrainerBase.load_loss_file(fn)
    fn.write_text("0 1.0\n1 0.9\n")
    assert TorchTrainerBase.load_loss_file(fn) == JaxTrainerBase.load_loss_file(fn) == [1.0, 0.9]
    TorchTrainerBase.write_to_loss_file(tmp_path / "w.txt", [1.5, 0.25])
    assert (tmp_path / "w.txt").read_text() == "0 1.5\n1 0.25"


# ---------------------------------------------------------------- samplers
def _ids(s):
    neg = s.get("negdocid")
    return (s["qid"], s["posdocid"], tuple(neg) if isinstance(neg, list) else neg)


def assert_same_samples(jax_samples, port_samples):
    assert [_ids(s) for s in port_samples] == [_ids(s) for s in jax_samples]
    for js, ps in zip(jax_samples, port_samples):
        for key in ARRAY_KEYS:
            if key in js:
                np.testing.assert_array_equal(ps[key], js[key], err_msg=key)


@pytest.mark.parametrize("name,config", [("triplet", {}), ("pair", {}), ("pair", {"seed": 3}), ("pred", {}),
                                         ("triplet", {"seed": 7})])
def test_sampler_streams_equal_jax(corpus, name, config):
    """The same (qid, pos, neg) stream and the same features for one seed."""
    rerankers = knrm_pair(corpus)
    jax_s, port_s = samplers(corpus, rerankers, name, config)
    n = len(port_s) if name == "pred" else 40
    assert_same_samples(draw(jax_s, n), draw(port_s, n))
    assert port_s.get_total_samples() == jax_s.get_total_samples()


def test_distill_sampler_stream_equals_jax(corpus, tmp_path):
    rng = np.random.Generator(np.random.PCG64(4))
    teacher = tmp_path / "teacher.run"
    with open(teacher, "wt") as fh:
        for qid, docs in corpus["run"].items():
            for rank, docid in enumerate(list(docs)[:-2]):  # two docs per query lack a teacher score
                fh.write(f"{qid} Q0 {docid} {rank + 1} {rng.standard_normal():.6f} teacher\n")
    rerankers = knrm_pair(corpus)
    jax_s, port_s = samplers(corpus, rerankers, "distill", {"teacherrunfile": str(teacher)})
    js, ps = draw(jax_s, 30), draw(port_s, 30)
    assert_same_samples(js, ps)
    np.testing.assert_array_equal([s["teacher_margin"] for s in ps], [s["teacher_margin"] for s in js])


@pytest.mark.parametrize("name,config", [("triplet", {}), ("LCE", {"nneg": 2})])
def test_bertpassage_training_stream_equals_jax(corpus, name, config):
    """bertpassage's one random valid passage per training doc (the extractor's
    own rng) and its stacked LCE negatives, draw for draw."""
    rerankers = bert_pair(corpus, extractor=dict(EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, numpassages=3))
    jax_s, port_s = samplers(corpus, rerankers, name, config)
    js, ps = draw(jax_s, 24), draw(port_s, 24)
    assert_same_samples(js, ps)
    if name == "LCE":
        assert ps[0]["neg_bert_input"].shape == (2, EXTRACTOR_TINY["maxseqlen"])


def test_embedtext_training_features_equal_jax(corpus):
    jax_rr, port_rr = knrm_pair(corpus)
    qid = "401"
    docs = list(corpus["run"][qid])
    for pos, neg in zip(docs, docs[1:]):
        want = jax_rr.extractor.id2vec(qid, pos, neg, label=[1, 0], training=True)
        got = port_rr.extractor.id2vec(qid, pos, neg, label=[1, 0], training=True)
        for key in ("query", "query_idf", "posdoc", "negdoc", "label"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_hard_negative_pools_equal_jax(corpus):
    rerankers = knrm_pair(corpus)
    jax_s, port_s = samplers(corpus, rerankers)
    assert port_s.hard_negative_pool() == jax_s.hard_negative_pool()
    mined = {"401": list(reversed(jax_s.hard_negative_pool()["401"]))[:3] + ["T99999"], "nope": ["x"]}
    assert port_s.set_hard_negatives(mined) == jax_s.set_hard_negatives(mined) == 1
    assert port_s.qid_to_negdocs == jax_s.qid_to_negdocs
    assert_same_samples(draw(jax_s, 20), draw(port_s, 20))


def test_select_hard_negatives_equals_jax():
    rng = np.random.Generator(np.random.PCG64(9))
    preds = {str(q): {f"D{d}": float(np.round(rng.standard_normal(), 1)) for d in range(30)} for q in range(5)}
    for depth in (1, 7, 40):
        assert select_hard_negatives(preds, depth) == jax_select_hard_negatives(preds, depth)


# ---------------------------------------------------------------- init
def test_init_statistics_match_flax(corpus):
    """Each parameter of the tiny BERT-MaxP and of KNRM (singlefc=False) drawn
    as flax draws it: zero biases, unit LayerNorm scales, and for every
    kernel and embedding table a std within 20% and a mean within 5 standard
    errors of the JAX init's (``lecun_normal``: truncated normal of variance
    1 / fan_in; embeddings N(0, 0.02))."""
    for jax_rr, port_rr in (bert_pair(corpus), knrm_pair(corpus, singlefc=False)):
        samples = draw(samplers(corpus, (jax_rr, port_rr))[0], 4)
        want = jax_flat(jax_rr.init_params(jax.random.PRNGKey(0), jax_collate(samples, ARRAY_KEYS)))
        got = flax_flat_params(port_rr.init_params(0))
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            assert g.shape == w.shape, key
            if key.endswith("/bias") or key.endswith("/scale"):
                np.testing.assert_array_equal(g, w, err_msg=key)
            elif key.endswith(("embedding", "mus", "sigmas")):
                np.testing.assert_array_equal(g, w, err_msg=key)  # the extractor's table and the KNRM bank
            else:
                std = float(w.std())
                assert abs(float(g.std()) - std) <= 0.2 * std, (key, g.std(), std)
                assert abs(float(g.mean()) - float(w.mean())) <= 5 * std * (2.0 / g.size) ** 0.5, key
                assert abs(g).max() <= abs(w).max() * 1.5 + 1e-6, key  # truncated at two stds


def test_init_is_deterministic_in_the_seed(corpus):
    _, port_rr = bert_pair(corpus)
    a = flax_flat_params(port_rr.init_params(3))
    b = flax_flat_params(port_rr.init_params(3))
    c = flax_flat_params(port_rr.init_params(4))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["params/classifier/kernel"], c["params/classifier/kernel"])


# ---------------------------------------------------------------- gradients and Adam steps
def jax_step_grads(jax_rr, params, step_batches):
    """The JAX trainer's gradient of one step: the mean of its micro-batches' gradients."""
    flats = [jax_grads(jax_rr, params, {k: v[g] for k, v in step_batches.items()})[1]
             for g in range(jax_rr.trainer.config["gradacc"])]
    return {k: sum(f[k] for f in flats) / len(flats) for k in flats[0]}


def trainable_keys(rr, flat):
    return [k for k in flat if rr.trainable(tuple(k.split("/")), flat[k])]


def load_flat(port_rr, model, flat):
    model.load_state_dict(port_rr.state_dict_from_params(flat))


def check_training_matches_jax(corpus, jax_rr, port_rr, sampler="triplet", own_steps=3, exclude=None):
    """From the JAX init, port against JAX:

    - step 1's loss and gradients (the port computes gradients for exactly the
      trainable weights);
    - 3 steps of the JAX trainer's optimizer (its optax ``tx``) and of the
      port's, both fed the JAX gradients of each step: the weights after them
      (the optimizer, its parameter groups, the schedule and the frozen
      weights, without the gradients' rounding);
    - ``own_steps`` steps of each trainer on its own gradients (the JAX
      trainer's jitted step, the port's ``train_step``): the losses, and the
      weights where every step's |g| is above GRAD_FLOOR.

    ``exclude`` ({key: [indices]}) names entries left out of the step-1
    gradients and the own steps' weights (ill-conditioned ones, each test
    says why)."""
    c = port_rr.trainer.config
    gradacc, batch = c["gradacc"], c["batch"]
    samples = draw(samplers(corpus, (jax_rr, port_rr), sampler)[0], 3 * gradacc * batch)
    params = carry_over(jax_rr, port_rr, samples[:batch])
    init = jax_flat(params)
    batches = steps(samples, gradacc, batch)
    keys = trainable_keys(port_rr, init)

    micro = {k: v[0] for k, v in batches[0].items()}
    j_loss, j_grads = jax_grads(jax_rr, params, micro)
    p_loss, p_grads = port_grads(port_rr, micro)
    assert set(p_grads) == set(keys), "the port computes gradients for exactly the trainable weights"
    assert_within(p_loss, j_loss, GRAD_TOL, "step-1 loss")
    for key in keys:
        scale = max(1.0, float(np.abs(j_grads[key]).max()))
        keep = np.ones(j_grads[key].shape, dtype=bool)
        keep[tuple(np.asarray((exclude or {}).get(key, []), dtype=int)[None])] = False
        assert np.isfinite(p_grads[key]).all(), key
        assert_within(p_grads[key][keep] / scale, j_grads[key][keep] / scale, GRAD_TOL, f"step-1 grad {key}")

    import optax

    from capreolus_tpu_torch.convert import _flax_leaves

    # the JAX trainer's optimizer and the port's, fed the same gradients
    jt, pt = jax_rr.trainer, port_rr.trainer
    tx = jt._make_optimizer(jax_rr, params)
    opt_state = tx.init(params)
    model = port_rr.build_train_model()
    load_flat(port_rr, model, init)
    optimizer = pt.make_optimizer(port_rr, model)
    named = dict(model.named_parameters())
    jparams, big = jax.tree_util.tree_map(jnp.array, params), {k: True for k in keys}
    for i, b in enumerate(batches):
        g = jax_step_grads(jax_rr, jparams, b)
        big = {k: big[k] & (np.abs(g[k]) > GRAD_FLOOR) for k in keys}
        tree_g = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.asarray(g["/".join(str(getattr(p, "key", p)) for p in path)]), jparams)
        updates, opt_state = tx.update(tree_g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        optimizer.zero_grad(set_to_none=True)
        for key, name, transposed in _flax_leaves(model):
            if key in keys:
                named[name].grad = torch.from_numpy(np.array(g[key].T if transposed else g[key], order="C"))
        pt.optimizer_step(optimizer, i)
    want, got = jax_flat(jparams), flax_flat_params(model)
    for key in init:
        if key not in keys:
            np.testing.assert_array_equal(got[key], init[key], err_msg=f"frozen {key} moved in the port")
            np.testing.assert_array_equal(want[key], init[key], err_msg=f"frozen {key} moved in JAX")
            continue
        lr = c["bertlr"] if "bert" in key else c["lr"]
        assert_within(got[key] / lr, want[key] / lr, STEP_TOL, f"3 Adam steps on the same gradients, {key} / lr")

    # each trainer's own steps: the JAX trainer's jitted step and the port's train_step
    train_step = jt._build_train_step(jax_rr, tx, jt._loss_fn())
    jparams, opt_state = jax.tree_util.tree_map(jnp.array, params), tx.init(params)
    load_flat(port_rr, model, init)
    optimizer = pt.make_optimizer(port_rr, model)
    for i, b in enumerate(batches[:own_steps]):
        jparams, opt_state, j_loss = train_step(jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()},
                                                jax.random.PRNGKey(i))
        p_loss = float(pt.train_step(port_rr, model, optimizer, b, i, pt.step_seed(0, i)))
        assert_within(p_loss, float(j_loss), GRAD_TOL if i == 0 else OWN_STEP_TOL, f"step {i + 1} loss")
    want, got = jax_flat(jparams), flax_flat_params(model)
    for key in keys:
        lr = c["bertlr"] if "bert" in key else c["lr"]
        mask = big[key].copy()
        mask[tuple(np.asarray((exclude or {}).get(key, []), dtype=int)[None])] = False
        if mask.any():
            print(f"{key}: {int(mask.sum())} of {mask.size} weights above the gradient floor")
            assert_within(got[key][mask] / lr, want[key][mask] / lr, OWN_STEP_TOL,
                          f"{own_steps} own steps, weights {key} / lr")


KNRM_SETTINGS = [{"gradkernels": g, "finetune": f} for g in (True, False) for f in (True, False)] + [
    {"singlefc": False, "gradkernels": False}]


@pytest.mark.parametrize("options", KNRM_SETTINGS, ids=lambda o: "-".join(f"{k}{v}" for k, v in o.items()))
def test_knrm_training_matches_jax(corpus, options):
    """With gradkernels=True the exact-match kernel (mu 1.0, sigma 0.001) takes
    a gradient of about (x - 1) / sigma^2 where x, the cosine of a token with
    itself, is 1 within an ulp: its sign is the rounding of that cosine, which
    differs between the packages. Its first Adam step, lr * sign(g), then
    moves it by 2 * lr apart and every later step follows, so there its
    gradient entries are left out of the step-1 comparison and the trainers'
    own steps are compared for one step only; the optimizer is held over 3
    steps on JAX's gradients in every setting."""
    jax_rr, port_rr = knrm_pair(corpus, trainer={"batch": 4, "lr": 1e-3, "itersize": 8}, **options)
    gradkernels = options.get("gradkernels", True)
    exact_match = [KNRM_SIGMAS.index(0.001)]
    check_training_matches_jax(corpus, jax_rr, port_rr, own_steps=1 if gradkernels else 3,
                               exclude={"params/mus": exact_match, "params/sigmas": exact_match} if gradkernels else None)


@pytest.mark.parametrize("trainer", [{"batch": 3}, {"batch": 2, "gradacc": 2, "lr": 2e-3, "bertlr": 5e-4},
                                     {"batch": 3, "loss": "crossentropy"}],
                         ids=["plain", "gradacc2-dual-lr", "crossentropy"])
def test_tiny_bert_training_matches_jax(corpus, trainer):
    """Tiny BERT-MaxP with dropout off (hidden_dropout_prob=0 on both sides)."""
    jax_rr, port_rr = bert_pair(corpus, trainer=dict({"lr": 1e-3, "bertlr": 1e-3, "itersize": 12}, **trainer))
    check_training_matches_jax(corpus, jax_rr, port_rr, sampler="pair" if "loss" in trainer else "triplet")


def test_bert_parameter_groups_follow_the_jax_labels(corpus):
    jax_rr, port_rr = bert_pair(corpus)
    model = port_rr.init_params(0)
    labels = port_rr.trainer.param_labels(port_rr, model)
    assert labels["classifier.weight"] == "other" and labels["bert.layer_0.attention.query.weight"] == "bert"
    assert set(labels.values()) == {"bert", "other"}
    optimizer = port_rr.trainer.make_optimizer(port_rr, model)
    assert [g["base_lr"] for g in optimizer.param_groups] == [port_rr.trainer.config["lr"],
                                                              port_rr.trainer.config["bertlr"]]


# ---------------------------------------------------------------- dropout and remat
def _bert_batch(corpus, port_rr, n=3):
    samples = draw(samplers(corpus, (port_rr, port_rr))[1], n)
    return collate(samples, ARRAY_KEYS)


def test_remat_gradients_equal_those_without(corpus):
    """remat recomputes each layer in the backward pass, dropout masks included
    (each site's generator is seeded, not a running stream)."""
    grads = []
    for remat in (False, True):
        _, port_rr = bert_pair(corpus, remat=remat, hidden_dropout_prob=0.2)
        model = port_rr.init_params(0)
        assert model.bert.config.remat is remat
        batch = _bert_batch(corpus, port_rr)
        loss = port_rr.trainer.compute_loss(port_rr, batch, torch.device("cpu"), dropout_seed=123)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], rtol=1e-6, atol=1e-7, msg=name)


def test_dropout_is_deterministic_per_step(corpus):
    _, port_rr = bert_pair(corpus, hidden_dropout_prob=0.3)
    port_rr.init_params(0)
    batch = _bert_batch(corpus, port_rr)
    device = torch.device("cpu")
    pt = port_rr.trainer

    def scores(seed):
        with torch.no_grad():
            return torch.stack(port_rr.score(batch, device, dropout_seed=seed))

    a, b = scores(pt.step_seed(1, 2)), scores(pt.step_seed(1, 2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, scores(pt.step_seed(1, 3)))
    assert not torch.equal(a, scores(pt.step_seed(2, 2)))
    with torch.no_grad():  # no seed: the inference forward, no dropout
        torch.testing.assert_close(port_rr.test(batch, device), port_rr._score_doc(
            *(port_rr.put(batch, k, device) for k in ("pos_bert_input", "pos_mask", "pos_seg"))), rtol=0, atol=0)


# ---------------------------------------------------------------- checkpoints
def test_msgpack_bytes_equal_flax(corpus):
    """flax's to_bytes of the JAX init, read and written back by the port, and
    the port's dev.best read and written back by flax, byte for byte."""
    from flax import serialization

    for jax_rr, port_rr in (knrm_pair(corpus, finetune=False), bert_pair(corpus)):
        samples = draw(samplers(corpus, (jax_rr, port_rr))[0], 2)
        params = jax_rr.init_params(jax.random.PRNGKey(0), jax_collate(samples, ARRAY_KEYS))
        stripped = jax_rr.trainer._strip_frozen(jax_rr, params)
        flax_bytes = serialization.to_bytes(stripped)
        assert flax_msgpack.to_bytes(flax_msgpack.from_bytes(flax_bytes)) == flax_bytes
        port_bytes = flax_msgpack.to_bytes(port_rr.trainer.saveable_params(port_rr, port_rr.init_params(1)))
        assert serialization.to_bytes(serialization.from_bytes(stripped, port_bytes)) == port_bytes


def test_msgpack_chunked_arrays_equal_flax(monkeypatch):
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"big": np.arange(50, dtype=np.float32).reshape(5, 10), "s": np.float32(2.5),
                       "i": np.arange(3, dtype=np.int64)}}
    flax_bytes = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == flax_bytes
    back = flax_msgpack.from_bytes(flax_bytes)
    np.testing.assert_array_equal(back["params"]["big"], tree["params"]["big"])
    assert back["params"]["s"] == np.float32(2.5)


def _score_both(jax_rr, port_rr, jax_params, batch):
    want = np.asarray(jax_rr.test(jax_params, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = port_rr.test(batch, torch.device("cpu")).numpy()
    return got, want


@pytest.mark.parametrize("which", ["knrm", "bert"])
def test_dev_best_loads_across_packages(corpus, tmp_path, which):
    """A dev.best written by the JAX trainer loads in the port, and one written
    by the port loads in the JAX trainer; both score the same candidates
    within MSGPACK_SCORE_TOL. Frozen weights are absent (empty) from the file."""
    jax_rr, port_rr = knrm_pair(corpus, finetune=False) if which == "knrm" else bert_pair(corpus)
    samples = draw(samplers(corpus, (jax_rr, port_rr), "pred")[0], 8)
    batch = collate(samples, ARRAY_KEYS)
    template = jax_rr.init_params(jax.random.PRNGKey(5), jax_collate(samples, ARRAY_KEYS))

    jax_rr.trainer.save_checkpoint(tmp_path / "jax" / "dev.best", template, {}, jax_rr)
    port_rr.init_params(9)
    port_rr.trainer._model = None
    port_rr.trainer.device = "cpu"
    port_rr.trainer.load_best_model(port_rr, tmp_path / "jax")
    got, want = _score_both(jax_rr, port_rr, template, batch)
    assert_within(got, want, MSGPACK_SCORE_TOL, f"{which}: JAX dev.best scored by the port")
    port_rr.trainer.save_checkpoint(tmp_path / "again" / "dev.best", port_rr.build_train_model(), None, port_rr)
    assert (tmp_path / "again" / "dev.best.params").read_bytes() == (tmp_path / "jax" / "dev.best.params").read_bytes()

    port_model = port_rr.init_params(11)
    port_rr.trainer.save_checkpoint(tmp_path / "port" / "dev.best", port_model, None, port_rr)
    flat = load_params(tmp_path / "port" / "dev.best")
    for key, value in flat.items():
        frozen = not port_rr.trainable(tuple(key.split("/")), value)
        assert (value.size == 0) == frozen, key
    loaded, _ = jax_rr.trainer.load_checkpoint(tmp_path / "port" / "dev.best", template, reranker=jax_rr)
    got, want = _score_both(jax_rr, port_rr, loaded, batch)
    assert_within(got, want, MSGPACK_SCORE_TOL, f"{which}: port dev.best scored by JAX")


# ---------------------------------------------------------------- the train loop
def _train(port_rr, corpus, out, sampler="triplet", dev=True):
    train_s = TorchSampler.create(sampler)
    train_s.prepare(corpus["run"], corpus["qrels"], port_rr.extractor)
    dev_s = TorchSampler.create("pred")
    dev_s.prepare(corpus["run"], corpus["qrels"], port_rr.extractor)
    port_rr.trainer.device = "cpu"
    metrics = port_rr.trainer.train(port_rr, train_s, out / "train", dev_s if dev else None, out / "dev",
                                    corpus["qrels"], "map")
    return metrics, train_s, dev_s


def test_fastforward_equals_an_uninterrupted_run(corpus, tmp_path):
    """A run cut after 2 of 3 iterations and resumed from its per-iteration
    checkpoints ends with the weights, loss history and dev.best of a run of 3."""
    cfg = {"niters": 3, "itersize": 8, "batch": 4, "lr": 0.05, "fastforward": True}
    _, full = knrm_pair(corpus, trainer=cfg, finetune=True)
    _train(full, corpus, tmp_path / "full")
    _, cut = knrm_pair(corpus, trainer=dict(cfg, niters=2), finetune=True)
    _train(cut, corpus, tmp_path / "resumed")
    _, resumed = knrm_pair(corpus, trainer=cfg, finetune=True)
    _train(resumed, corpus, tmp_path / "resumed")
    want = TorchTrainerBase.load_loss_file(tmp_path / "full" / "train" / "info" / "loss.txt")
    assert TorchTrainerBase.load_loss_file(tmp_path / "resumed" / "train" / "info" / "loss.txt") == want
    a, b = flax_flat_params(full.build_train_model()), flax_flat_params(resumed.build_train_model())
    for key in a:
        np.testing.assert_array_equal(b[key], a[key], err_msg=key)
    assert (tmp_path / "resumed" / "train" / "dev.best.params").read_bytes() == \
        (tmp_path / "full" / "train" / "dev.best.params").read_bytes()


def test_train_writes_the_jax_artifacts(corpus, tmp_path):
    _, port_rr = knrm_pair(corpus, trainer={"niters": 2, "itersize": 8, "batch": 4, "validatefreq": 1})
    metrics, _, _ = _train(port_rr, corpus, tmp_path)
    train = tmp_path / "train"
    for name in ("dev.best.params", "dev.best.optstate", "dev.best.done", "info/loss.txt",
                 "info/summaries/param_stats_0.json"):
        assert (train / name).exists(), name
    assert json.loads((tmp_path / "dev" / "metrics.json").read_text()) == metrics
    assert set(metrics) == {"map", "P_20", "ndcg_cut_20"}
    stats = json.loads((train / "info" / "summaries" / "param_stats_0.json").read_text())
    assert stats["params/combine/kernel"]["shape"] == [11, 1]
    from capreolus_tpu_torch.core import constants

    events = list((Path(constants["RESULTS_BASE_PATH"]) / "runs" / "default").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0  # TensorBoard scalars and histograms
    assert len(TorchTrainerBase.load_loss_file(train / "info" / "loss.txt")) == 2


def test_negrefresh_swaps_in_the_hardest_negatives(corpus, tmp_path):
    """With negrefresh=1 the sampler's live pools become the current model's
    top-neghard negatives of the original pools, as select_hard_negatives ranks them."""
    _, port_rr = knrm_pair(corpus, trainer={"niters": 2, "itersize": 8, "batch": 4, "negrefresh": 1,
                                            "neghard": 3})
    _, train_s, _ = _train(port_rr, corpus, tmp_path)
    pool = train_s.hard_negative_pool()
    preds = port_rr.trainer.predict(port_rr, train_s._mining_sampler)
    assert set(preds) == set(pool)
    want = select_hard_negatives(preds, 3)
    # the refresh ran after iteration 0; the pools hold 3 negatives from the original pool each
    for qid, negs in train_s.qid_to_negdocs.items():
        assert len(negs) == 3 and set(negs) <= set(pool[qid]), qid
    assert all(len(v) == 3 for v in want.values())


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("trainer,item", [
    ({"tp": 2}, "Multi-device"), ({"pp": 2}, "Multi-device"), ({"ep": 2}, "Multi-device"),
    ({"sp": True}, "Multi-device"), ({"fsdp": True}, "Multi-device"), ({"ckpt": "sharded"}, "Multi-device"),
    ({"ckpt": "sharded_async"}, "Multi-device"), ({"amp": "both"}, "amp slice"), ({"amp": "train"}, "amp slice"),
    ({"loss": "infonce"}, "Dense"),
])
def test_unported_trainer_options_raise(corpus, tmp_path, trainer, item):
    _, port_rr = knrm_pair(corpus, trainer=dict({"niters": 1, "itersize": 4, "batch": 4}, **trainer))
    with pytest.raises(ConfigError, match=item):
        _train(port_rr, corpus, tmp_path)


@pytest.mark.parametrize("trainer,match", [({"loss": "lce"}, "score_lce"), ({"loss": "nope"}, "unknown loss"),
                                           ({"loss": "lce", "softmaxloss": True}, "softmaxloss"),
                                           ({"amp": "fp8"}, "amp must be"), ({"ckpt": "tape"}, "ckpt must be"),
                                           ({"loss": "margin_mse"}, "teacher margins"),
                                           ({"negrefresh": 1}, "negrefresh")])
def test_trainer_config_errors_as_jax(corpus, tmp_path, trainer, match):
    _, port_rr = knrm_pair(corpus, trainer=dict({"niters": 1, "itersize": 4, "batch": 4}, **trainer))
    with pytest.raises(ConfigError, match=match):
        _train(port_rr, corpus, tmp_path, sampler="distill" if "negrefresh" in trainer else "triplet") \
            if "negrefresh" not in trainer else _distill_train(port_rr, corpus, tmp_path)


def _distill_train(port_rr, corpus, tmp_path):
    teacher = tmp_path / "teacher.run"
    teacher.write_text("".join(f"{q} Q0 {d} 1 {i * 0.1} t\n" for q, docs in corpus["run"].items()
                               for i, d in enumerate(docs)))
    train_s = TorchSampler.create("distill", {"teacherrunfile": str(teacher)})
    train_s.prepare(corpus["run"], corpus["qrels"], port_rr.extractor)
    port_rr.trainer.device = "cpu"
    port_rr.trainer.train(port_rr, train_s, tmp_path / "t", None, tmp_path / "d", corpus["qrels"])


@pytest.mark.parametrize("options,match", [({"lora": 4}, "item 4"), ({"moeexperts": 2}, "item 6")])
def test_unported_bert_options_name_their_roadmap_item(corpus, options, match):
    with pytest.raises(ConfigError, match=match):
        bert_pair(corpus, **options)



def test_a_bert_training_step_moves_every_encoder_weight(corpus):
    """The training forward is differentiable through every layer: one step
    of the port's trainer (dropout on) changes every parameter tensor of the
    tiny BERT-MaxP's encoder (a kernel without a backward on the path would
    leave every weight below it at a zero gradient). The head's bias is the
    one weight that stays: a pairwise loss cancels it, so its gradient is 0."""
    _, port_rr = bert_pair(corpus, hidden_dropout_prob=0.1, trainer={"batch": 3, "lr": 1e-3, "bertlr": 1e-3})
    model = port_rr.init_params(0)
    optimizer = port_rr.trainer.make_optimizer(port_rr, model)
    batch = {k: v[None] for k, v in _bert_batch(corpus, port_rr).items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    port_rr.trainer.train_step(port_rr, model, optimizer, batch, 0, port_rr.trainer.step_seed(0, 0))
    unmoved = [n for n, p in model.named_parameters() if torch.equal(p.detach(), before[n])]
    assert unmoved == ["classifier.bias"], unmoved


def test_profile_traces_the_first_iteration_and_evalbatch_leaves_scores(corpus, tmp_path):
    """profile=True writes one torch.profiler trace of the first iteration;
    evalbatch changes the prediction batches, not the scores."""
    _, port_rr = knrm_pair(corpus, trainer={"niters": 1, "itersize": 8, "batch": 4, "profile": True})
    _, _, dev_s = _train(port_rr, corpus, tmp_path)
    trace = tmp_path / "train" / "info" / "profile" / "trace.json"
    assert trace.exists() and json.loads(trace.read_text())["traceEvents"]
    want = port_rr.trainer.predict(port_rr, dev_s)
    port_rr.trainer.config["evalbatch"] = 5
    got = port_rr.trainer.predict(port_rr, dev_s)
    assert got.keys() == want.keys()
    for qid in want:
        assert list(got[qid]) == list(want[qid])
        np.testing.assert_allclose(list(got[qid].values()), list(want[qid].values()), rtol=1e-6, atol=1e-6)
