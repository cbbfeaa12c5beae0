"""The PyTorch port's device metrics (``evaluation/device_metrics.py``)
against the JAX package's ``eval_runs_device`` and the port's host
``eval_runs``, on the CPU, over ``tests/test_device_metrics.py``'s random
experiments (seeds 0-2, relevance levels 1 and 2, all nine metrics).

Tolerances: against JAX's device metrics 1e-6 (both f32; sums in other
orders); against the host's f64 metrics 1e-5 (the JAX suite's own).
The trainer's validation takes the device path when every metric is
supported, and the host path otherwise, as the JAX trainer chooses.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.evaluation.device_metrics import device_supported as jax_device_supported  # noqa: E402
from capreolus_tpu.evaluation.device_metrics import eval_runs_device as jax_eval_runs_device  # noqa: E402
from capreolus_tpu_torch.evaluation import eval_runs  # noqa: E402
from capreolus_tpu_torch.evaluation import device_metrics as dm  # noqa: E402
from test_device_metrics import METRICS, random_experiment  # noqa: E402

JAX_TOL = 1e-6
HOST_TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("relevance_level", [1, 2])
def test_device_metrics_match_jax_and_the_host(seed, relevance_level):
    qrels, runs = random_experiment(seed)
    got = dm.eval_runs_device(runs, qrels, METRICS, relevance_level, device="cpu")
    want = jax_eval_runs_device(runs, qrels, METRICS, relevance_level)
    host = eval_runs(runs, qrels, list(METRICS), relevance_level)
    assert list(got) == METRICS
    for metric in METRICS:
        assert got[metric] == pytest.approx(want[metric], abs=JAX_TOL), metric
        assert got[metric] == pytest.approx(host[metric], abs=HOST_TOL), metric


def test_device_empty_and_edge_cases():
    qrels = {"q1": {"d1": 1}}
    assert dm.eval_runs_device({}, qrels, ["map"], device="cpu") == {"map": 0.0}
    out = dm.eval_runs_device({"q1": {}}, qrels, ["map", "ndcg_cut_10"], device="cpu")
    assert out["map"] == 0.0  # a query with an empty run contributes zeros
    out = dm.eval_runs_device({"q1": {"d1": 1.0}}, qrels, ["map", "recip_rank", "ndcg_cut_10"], device="cpu")
    assert out == {"map": 1.0, "recip_rank": 1.0, "ndcg_cut_10": 1.0}
    # no query with a relevant doc at the level: zeros, as JAX
    assert dm.eval_runs_device({"q1": {"d1": 1.0}}, qrels, ["map", "P_5"], relevance_level=2, device="cpu") == \
        jax_eval_runs_device({"q1": {"d1": 1.0}}, qrels, ["map", "P_5"], relevance_level=2)
    with pytest.raises(ValueError, match="not supported on device"):
        dm.eval_runs_device({"q1": {"d1": 1.0}}, qrels, ["bpref"], device="cpu")


def test_functions_match_jax_on_ties_and_depth_caps():
    """``reciprocal_rank`` takes the first relevant rank (``torch.argmax``'s
    first maximum, as ``jnp.argmax``), capped at k; a row with no relevant
    doc scores 0; every function's values equal JAX's within 1e-6."""
    import jax.numpy as jnp

    from capreolus_tpu.evaluation import device_metrics as jdm

    rng = np.random.Generator(np.random.PCG64(4))
    flags = (rng.random((7, 25)) < 0.2).astype(np.float32)
    flags[0] = 0.0
    flags[1, :12] = 0.0
    flags[1, 12] = 1.0
    gains = flags * rng.integers(1, 4, size=flags.shape).astype(np.float32)
    ideal = -np.sort(-gains, axis=1)
    num_rel = flags.sum(axis=1) + np.float32(1)
    t, j = (lambda a: torch.from_numpy(a)), jnp.asarray
    pairs = [
        (dm.reciprocal_rank(t(flags)), jdm.reciprocal_rank(j(flags))),
        (dm.reciprocal_rank(t(flags), k=10), jdm.reciprocal_rank(j(flags), k=10)),
        (dm.average_precision(t(flags), t(num_rel)), jdm.average_precision(j(flags), j(num_rel))),
        (dm.ndcg_at_k(t(gains), t(ideal), 20), jdm.ndcg_at_k(j(gains), j(ideal), 20)),
        (dm.precision_at_k(t(flags), 5), jdm.precision_at_k(j(flags), 5)),
        (dm.recall_at_k(t(flags), t(num_rel), 10), jdm.recall_at_k(j(flags), j(num_rel), 10)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_TOL, rtol=0)
    rr = dm.reciprocal_rank(t(flags), k=10).numpy()
    assert rr[0] == 0.0 and rr[1] == 0.0 and dm.reciprocal_rank(t(flags)).numpy()[1] == pytest.approx(1 / 13)


@pytest.mark.parametrize("metrics", [["map", "P_20", "ndcg_cut_20"], ["map", "MRR@10", "recall_1000"],
                                     ["map", "bpref"], ["ndcg_cut_x"], ["P_5", "judged_10"]])
def test_device_supported_as_jax(metrics):
    assert dm.device_supported(metrics) == jax_device_supported(metrics)


@pytest.mark.parametrize("metric,device_path", [("map", True), ("bpref", False)])
def test_trainer_validation_takes_the_device_path_when_supported(metric, device_path, monkeypatch):
    from capreolus_tpu_torch.trainer import Trainer

    trainer = Trainer.create("jax", {})
    trainer.device = "cpu"
    qrels, runs = random_experiment(1)
    calls = []
    real = dm.eval_runs_device
    monkeypatch.setattr(dm, "eval_runs_device", lambda *a, **kw: calls.append(kw.get("device")) or real(*a, **kw))
    metrics = trainer._validation_metrics(metric)
    got = trainer._eval_dev_runs(runs, qrels, metrics, 1)
    host = eval_runs(runs, qrels, metrics, 1)
    assert trainer.device_validations == int(device_path) and len(calls) == int(device_path)
    assert not device_path or calls == [torch.device("cpu")]
    for m in metrics:
        assert got[m] == pytest.approx(host[m], abs=HOST_TOL), m
