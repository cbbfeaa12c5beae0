"""The rerank pins through the port's ``rerank.traineval`` on the CPU, over the
JAX suite's rerank golden (``tests/test_e2e_rerank_golden.py``: BM25 ties all
40 candidates of a topic, a marker signal only a trained reranker can see).

- The corpus ``chip_smoke.rerank_golden_corpus`` builds (and the card's phase
  9a trains on) is that suite's.
- The first stage is tied and weak (test MAP 0.3329, within 0.1).
- tiny-BERT MaxP: test MAP within 0.1 of its pin 1.0, more than 0.2 above the
  first stage.
- KNRM: more than 0.2 above the first stage at the default config. Its test
  MAP is a chaotic function of the init and of float rounding: the JAX
  package's own runs of this config span 0.66-0.95 over trainer seeds 40-47
  (``tests/torch_rerank_seed_spread.py``), and the port draws its init from
  a ``torch.Generator`` (the same distributions, other values). So the pin
  0.7977 is held two ways: the port's mean over 8 trainer seeds within 0.1
  of it, and one run from the JAX package's own init (carried over, the
  port's trainer from there on) within 0.1 of it.
"""

import copy

import jax
import numpy as np
import pytest
import torch

import capreolus_tpu_torch

capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu_torch.core import constants as port_constants  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from chip_smoke import (RERANK_GAIN, RERANK_GOLDEN, RERANK_GOLDEN_CONFIGS, RERANK_PIN_TOL,  # noqa: E402
                        golden_map as map_of, rerank_golden_corpus, rerank_golden_run, setup_rerank_golden)
from test_e2e_rerank_golden import build_rerank_corpus  # noqa: E402

PINS = RERANK_GOLDEN["pins"]
SEEDS = range(42, 50)  # 8 trainer seeds from the default


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_rerank_golden")
    saved = port_constants["CACHE_BASE_PATH"], port_constants["RESULTS_BASE_PATH"]
    port_constants["CACHE_BASE_PATH"], port_constants["RESULTS_BASE_PATH"] = base / "cache", base / "results"
    try:
        topics, qrels = setup_rerank_golden(str(base))
        qids = sorted(topics)
        train, dev = RERANK_GOLDEN["split"][0], sum(RERANK_GOLDEN["split"][:2])
        yield {"qrels": qrels, "dev": qids[train:dev], "test": qids[dev:], "base": base}
    finally:
        port_constants["CACHE_BASE_PATH"], port_constants["RESULTS_BASE_PATH"] = saved


def run(golden, name, **trainer):
    cfg = copy.deepcopy(RERANK_GOLDEN_CONFIGS[name])
    cfg["trainer"].update(trainer)
    _, first_stage, preds = rerank_golden_run(cfg, "cpu")
    return (map_of(first_stage, golden["qrels"], golden["test"]), map_of(preds["test"], golden["qrels"], golden["test"]),
            map_of(preds["dev"], golden["qrels"], golden["dev"]))


def test_chip_smoke_rerank_corpus_is_the_jax_suites():
    assert rerank_golden_corpus() == build_rerank_corpus()


def test_tinybert_traineval_meets_its_pin(golden):
    first, test, dev = run(golden, "BERTMaxP")
    print(f"tiny-BERT: first stage {first:.4f} -> test {test:.4f} (pin {PINS['BERTMaxP']}), dev {dev:.4f}")
    assert first == pytest.approx(PINS["first_stage"], abs=RERANK_PIN_TOL) and first < 0.45
    assert test > first + RERANK_GAIN
    assert test == pytest.approx(PINS["BERTMaxP"], abs=RERANK_PIN_TOL)
    assert dev > 0.5


def test_knrm_traineval_beats_the_first_stage(golden):
    first, test, dev = run(golden, "KNRM")
    print(f"KNRM: first stage {first:.4f} -> test {test:.4f} (pin {PINS['KNRM']}), dev {dev:.4f}")
    assert test > first + RERANK_GAIN
    assert dev > 0.5


def test_knrm_mean_over_trainer_seeds_meets_the_pin(golden):
    maps = [run(golden, "KNRM", seed=seed)[1] for seed in SEEDS]
    print("KNRM test MAP by trainer seed:", dict(zip(SEEDS, np.round(maps, 4))), f"mean {np.mean(maps):.4f}")
    assert float(np.mean(maps)) == pytest.approx(PINS["KNRM"], abs=RERANK_PIN_TOL)


def test_knrm_from_the_jax_init_meets_the_pin(golden, monkeypatch):
    """The port's rerank.traineval started from the JAX package's init of the
    same config (PRNGKey(seed) through flax), the port's trainer from there on."""
    from capreolus_tpu.reranker.knrm import KNRMModel as JaxKNRMModel
    from test_torch_knrm import flatten_params

    port_init = TorchReranker.init_params

    def jax_init(self, seed):
        model = port_init(self, seed)
        jax_model = JaxKNRMModel(embedding_init=self.extractor.embeddings, finetune=self.config["finetune"],
                                 gradkernels=self.config["gradkernels"], singlefc=self.config["singlefc"],
                                 scoretanh=self.config["scoretanh"])
        ex = self.extractor.config
        params = jax_model.init(jax.random.PRNGKey(seed), np.zeros((1, ex["maxqlen"]), np.int64),
                                np.zeros((1, ex["maxdoclen"]), np.int64), None)
        model.load_state_dict(self.state_dict_from_params(flatten_params(params)))
        return model

    monkeypatch.setattr(TorchReranker, "init_params", jax_init)
    monkeypatch.setitem(port_constants, "RESULTS_BASE_PATH", golden["base"] / "results_jax_init")
    first, test, _ = run(golden, "KNRM")
    print(f"KNRM from the JAX init: first stage {first:.4f} -> test {test:.4f} (pin {PINS['KNRM']})")
    assert test > first + RERANK_GAIN
    assert test == pytest.approx(PINS["KNRM"], abs=RERANK_PIN_TOL)
