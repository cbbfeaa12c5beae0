"""Helpers of the reranker zoo's tests in the port (``tests/test_torch_interaction.py``,
``test_torch_sequence.py``, ``test_torch_zoo_train.py``): a JAX reranker and
the port's of one config over one seeded corpus, the port's model loaded with
the JAX init through ``convert.flax_state_dict``, the same collated batches
fed to both.

Tolerances:
- ``FORWARD_TOL`` 1e-5: ``test`` scores, f32 sums in other orders.
- ``GRAD_TOL`` 1e-4: step 1's loss, and each gradient tensor against its
  largest entry, or the largest entry of either of its two uses' gradients
  where that is larger (the pairwise loss subtracts the negative's gradient
  from the positive's, and where the two nearly cancel, as DRMM's histogram
  layers' do for terms neither doc matches, the difference keeps their
  rounding), floored at ``GRAD_NOISE_FLOOR`` (1e-3) of the model's largest
  entry (chip_smoke.py phase 9a's rule). The forwards are the deterministic
  ones: JAX ``score(params, batch)`` without rngs, the port's
  ``score(batch, device)`` without a dropout seed.
- ``STEP_TOL`` 1e-4: weights after 3 Adam steps of each package's optimizer
  on the same (JAX) gradients, divided by the learning rate
  (``tests/test_torch_trainer.py``: optax rounds Adam's bias correction in f32).
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

from capreolus_tpu.trainer.jax_trainer import collate as jax_collate  # noqa: E402
from capreolus_tpu_torch.convert import flax_flat_params, flax_leaves  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS  # noqa: E402
from test_torch_bert import assert_within  # noqa: E402
from test_torch_index import write_trec_corpus  # noqa: E402
from test_torch_trainer import draw, jax_flat, make_rerankers, samplers, steps  # noqa: E402

FORWARD_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_NOISE_FLOOR = 1e-3
STEP_TOL = 1e-4

ZOO_EXTRACTOR = {"embeddings": "random8", "maxqlen": 4, "maxdoclen": 24}
DEEPTILES_EXTRACTOR = dict(ZOO_EXTRACTOR, slicelen=8, passagelen=4)
BATCH = 3
# the exact-match kernel (mu 1.0, sigma 0.001) takes a gradient of about (x - 1) / sigma^2 at a
# cosine x that is 1 within an ulp: its sign is rounding (tests/test_torch_trainer.py, KNRM)
EXACT_MATCH_KERNEL = 10


def zoo_corpus_at(base):
    """A 60-doc seeded corpus under ``base``, 4 queries of 12 candidates each
    (3 relevant), as ``tests/test_torch_trainer.py``'s ``corpus``."""
    docs = write_trec_corpus(base / "corpus", num_docs=60, seed=5, min_len=20, max_len=60)
    rng = np.random.Generator(np.random.PCG64(3))
    ids = [d for d, _ in docs]
    run, qrels, topics = {}, {}, {}
    for q in range(4):
        qid = str(400 + q)
        cands = [ids[i] for i in rng.choice(len(ids), size=12, replace=False)]
        run[qid] = {d: float(12 - i) for i, d in enumerate(cands)}
        qrels[qid] = {d: int(i % 4 == 0) for i, d in enumerate(cands)}
        topics[qid] = " ".join(docs[int(rng.integers(len(docs)))][1].split()[:3])
    return {"collection": {"name": "dummy", "path": str(base / "corpus")}, "run": run, "qrels": qrels,
            "topics": topics, "docids": sorted({d for r in run.values() for d in r})}


@pytest.fixture(scope="module")
def zoo_corpus(tmp_path_factory):
    """``zoo_corpus_at`` with both packages' caches under one module tmpdir."""
    from capreolus_tpu.core import constants as jax_constants
    from capreolus_tpu_torch.core import constants as torch_constants

    base = tmp_path_factory.mktemp("zoo")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_constants, "CACHE_BASE_PATH", base / "cache")
        mp.setitem(jax_constants, "RESULTS_BASE_PATH", base / "results")
        mp.setitem(torch_constants, "CACHE_BASE_PATH", base / "torch_cache")
        mp.setitem(torch_constants, "RESULTS_BASE_PATH", base / "torch_results")
        yield zoo_corpus_at(base)


def case_id(case):
    name, options = case
    return name + "".join(f"-{k}{v}" for k, v in options.items() if k != "extractor")


class ZooCase:
    """One config's JAX and port rerankers, the JAX init carried into the
    port's model, and 3 training batches of ``BATCH`` triplets."""

    def __init__(self, corpus, name, options, init_seed=0, perturb_biases=False, dyadic_embedding=False,
                 jax_model=None):
        options = json.loads(json.dumps(options))
        options.setdefault("extractor", dict(DEEPTILES_EXTRACTOR if name == "DeepTileBar" else ZOO_EXTRACTOR))
        options.setdefault("trainer", {"batch": BATCH, "lr": 1e-3, "itersize": 3 * BATCH})
        if name == "DSSM":
            options["extractor"] = {k: v for k, v in options["extractor"].items() if k in ("maxqlen", "datamode")}
        self.jax_rr, self.port_rr = make_rerankers(corpus, name, options)
        if jax_model is not None:  # the JAX model built by the caller, where its reranker's cannot be
            self.jax_rr.model = jax_model(self.jax_rr)
        samples = draw(samplers(corpus, (self.jax_rr, self.port_rr))[0], 3 * BATCH)
        self.batches = [{k: v[0] for k, v in b.items()} for b in steps(samples, 1, BATCH)]
        self.params = self.jax_rr.init_params(jax.random.PRNGKey(init_seed), jax_collate(samples[:BATCH], ARRAY_KEYS))
        if perturb_biases:
            self.params = _perturbed_biases(self.params, init_seed)
        if dyadic_embedding:
            self.params = _dyadic_embedding(self.params)
        self.init = jax_flat(self.params)
        self.model = self.port_rr.init_params(init_seed + 1)
        self.model.load_state_dict(self.port_rr.state_dict_from_params(self.init))
        self.keys = [k for k in self.init if self.port_rr.trainable(tuple(k.split("/")), self.init[k])]

    def jax_test(self, batch, params=None):
        return np.asarray(self.jax_rr.test(self.params if params is None else params,
                                           {k: jnp.asarray(v) for k, v in batch.items()}))

    def port_test(self, batch):
        with torch.no_grad():
            return self.port_rr.test(batch, torch.device("cpu")).numpy()

    def jax_grads(self, params, batch):
        """The pairwise loss of the deterministic JAX forward and its gradient."""
        fn = getattr(self, "_jax_value_and_grad", None)
        if fn is None:
            loss_fn = self.jax_rr.trainer._loss_fn()

            def loss(p, b):
                pos, neg = self.jax_rr.score(p, b)
                return loss_fn([pos.astype(jnp.float32), neg.astype(jnp.float32)])

            fn = self._jax_value_and_grad = jax.jit(jax.value_and_grad(loss))
        value, grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
        return float(value), jax_flat(grads)

    def port_grads(self, batch):
        """The port trainer's loss of the deterministic forward (no dropout
        seed) and its gradients, in the JAX layout."""
        model = self.port_rr.build_train_model()
        model.zero_grad(set_to_none=True)
        self.port_rr.trainer.make_optimizer(self.port_rr, model)  # freezes what the trainer freezes
        loss = self.port_rr.trainer.compute_loss(self.port_rr, batch, torch.device("cpu"), dropout_seed=None)
        loss.backward()
        named = dict(model.named_parameters())
        return float(loss.detach()), {key: to_flax(named[name].grad).numpy().copy()
                                      for key, name, to_flax, _, _ in flax_leaves(model)
                                      if named[name].grad is not None}

    def port_use_grads(self, batch):
        """The gradients of the hinge's two uses apart (the port's, in the JAX
        layout): of the mean over the samples whose hinge is active of the
        positive's score, and of the negative's."""
        model = self.port_rr.build_train_model()
        self.port_rr.trainer.make_optimizer(self.port_rr, model)
        out = []
        for which in (0, 1):
            model.zero_grad(set_to_none=True)
            pos, neg = self.port_rr.score(batch, torch.device("cpu"))
            active = ((1.0 - (pos - neg)) > 0).float().detach()
            torch.mean(active * (pos, neg)[which]).backward()
            named = dict(model.named_parameters())
            out.append({key: to_flax(named[name].grad).numpy().copy() for key, name, to_flax, _, _ in flax_leaves(model)
                        if named[name].grad is not None})
        return out


def _perturbed_biases(params, seed):
    """The init with every bias drawn N(0, 0.1) (flax draws them 0)."""
    rng = np.random.Generator(np.random.PCG64(seed + 100))
    return jax.tree_util.tree_map_with_path(
        lambda path, v: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * np.float32(0.1))
        if str(getattr(path[-1], "key", "")) == "bias" else v, params)


def _dyadic_embedding(params):
    """The init with the embedding table rounded to multiples of 1/16: every
    dot product and squared norm of its rows is then exact in f32 whatever the
    summation order, so both packages' similarity matrices are bit-identical."""
    inner = dict(params["params"])
    inner["embedding"] = jnp.round(inner["embedding"] * 16.0) / 16.0
    return {**params, "params": inner}


def check_forward(case):
    """``test`` scores of each training batch's positive and negative docs."""
    for i, batch in enumerate(case.batches):
        for side in ("posdoc", "negdoc"):
            b = dict(batch, posdoc=batch[side])
            got, want = case.port_test(b), case.jax_test(b)
            assert got.shape == want.shape == (BATCH,) and np.isfinite(got).all()
            assert_within(got, want, FORWARD_TOL, f"batch {i} {side} scores")


def check_gradients(case, exclude=None):
    """Step 1's loss and gradients; the port computes gradients for exactly
    the trainable weights. ``exclude`` ({key: [indices]}) leaves out entries
    whose gradient is rounding (the caller says why)."""
    j_loss, j_grads = case.jax_grads(case.params, case.batches[0])
    p_loss, p_grads = case.port_grads(case.batches[0])
    assert set(p_grads) == set(case.keys), "the port computes gradients for exactly the trainable weights"
    assert_within(p_loss, j_loss, GRAD_TOL, "step-1 loss")
    assert j_loss > 0, "the hinge is inactive: no gradient to compare"
    model_scale = max(float(np.abs(g).max()) for g in j_grads.values())
    uses = case.port_use_grads(case.batches[0])
    for key in case.keys:
        keep = np.ones(j_grads[key].shape, dtype=bool)
        keep[tuple(np.asarray((exclude or {}).get(key, []), dtype=int)[None])] = False
        scale = max([float(np.abs(g[key][keep]).max(initial=0.0)) for g in [j_grads] + uses if key in g]
                    + [GRAD_NOISE_FLOOR * model_scale])
        assert np.isfinite(p_grads[key]).all(), key
        assert_within(p_grads[key][keep] / scale, j_grads[key][keep] / scale, GRAD_TOL, f"step-1 grad {key}")


def check_adam_steps(case):
    """3 steps of the JAX trainer's optimizer and of the port's, both fed JAX's
    gradients: trainable weights within STEP_TOL of the learning rate, frozen
    weights unmoved in both."""
    import optax

    jt, pt = case.jax_rr.trainer, case.port_rr.trainer
    tx = jt._make_optimizer(case.jax_rr, case.params)
    opt_state = tx.init(case.params)
    model = case.port_rr.build_train_model()
    model.load_state_dict(case.port_rr.state_dict_from_params(case.init))
    optimizer = pt.make_optimizer(case.port_rr, model)
    named = dict(model.named_parameters())
    jparams = jax.tree_util.tree_map(jnp.array, case.params)
    for i, batch in enumerate(case.batches):
        _, g = case.jax_grads(jparams, batch)
        tree_g = jax.tree_util.tree_map_with_path(
            lambda path, v: jnp.asarray(g["/".join(str(getattr(p, "key", p)) for p in path)]), jparams)
        updates, opt_state = tx.update(tree_g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        optimizer.zero_grad(set_to_none=True)
        for key, name, _, from_flax, _ in flax_leaves(model):
            if key in case.keys:
                named[name].grad = from_flax(torch.from_numpy(np.array(g[key], order="C"))).contiguous()
        pt.optimizer_step(optimizer, i)
    want, got = jax_flat(jparams), flax_flat_params(model)
    lr = pt.config["lr"]
    for key in case.init:
        if key in case.keys:
            assert_within(got[key] / lr, want[key] / lr, STEP_TOL, f"3 Adam steps, {key} / lr")
        else:
            np.testing.assert_array_equal(got[key], case.init[key], err_msg=f"frozen {key} moved in the port")
            np.testing.assert_array_equal(want[key], case.init[key], err_msg=f"frozen {key} moved in JAX")
