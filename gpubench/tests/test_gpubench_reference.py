"""The plain reference against the port at tiny widths on the CPU, the
control's readings beside the program's, and the faults a cell can have
coming out as not correct."""

import numpy as np
import pytest
import torch

import run as bench_run
from conftest import tiny_scale
from lib import registry

SEED = 2 ** 31 + 12345


def tiny_run(bench, name, tmp_path, patch=None, seconds=1.0):
    w = registry.workload(bench, name)
    return bench_run.run_cell(bench, w, SEED, seconds, 0, "cpu", str(tmp_path), scale=tiny_scale(name), t0=0.0,
                              patch=patch)


# the CPU runs the port's plain versions, the reference's arithmetic but for summation order; the int8
# ColBERT engine rounds its int32 similarities to bf16 (as the JAX scorer does), which the reference does not
@pytest.mark.parametrize("name,tol", [("maxp-int8-rerank", 1e-4), ("colbert-bf16-b64", 1e-4),
                                      ("colbert-int8-b64", 0.05), ("maxp-train", 1e-4)])
def test_a_tiny_run_is_correct_and_its_gaps_are_rounding(bench, cpu_cache, name, tol):
    result = tiny_run(bench, name, cpu_cache)
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] < tol for c in result["checks"].values()), result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", ["maxp-int8-rerank", "colbert-bf16-b64", "colbert-int8-b64", "maxp-train"])
def test_a_tiny_traced_run_reads_its_per_layer_metrics(bench, cpu_cache, name):
    w = registry.workload(bench, name)
    result = bench_run.run_cell(bench, w, SEED, 1.0, 1, "cpu", str(cpu_cache), scale=tiny_scale(name), t0=0.0)
    wanted = {m["name"] for m in registry.metrics_of(bench, name, 1)}
    # no kernel runs on the CPU: the rooflines find nothing to read and stay out of the line
    assert {k for k in wanted if "roofline" not in k} <= set(result["metrics"]) <= wanted
    assert result["device"]["window_s"] > 0 and result["correct"]


def test_the_reference_first_stage_and_features_are_the_ports(bench, cpu_cache):
    """BM25's top 100 and bertpassage's inputs, re-derived, equal the port's."""
    from capreolus_tpu_torch.serving import RetrievalService

    plain = registry.load_module("reference", "plain")
    w = registry.workload(bench, "maxp-int8-rerank")
    config = registry.load_json("configs", w["config"])
    mix = registry.load_json("traffic", w["traffic"])
    system = registry.load_module("systems", config["system"]).System(config, mix, SEED, "cpu", str(cpu_cache),
                                                                       tiny_scale(w["name"]))
    bm25 = plain.BM25(system.docs)
    for query in system.topics[:5]:
        hits = RetrievalService.search_async(system.svc, [query], k=100)()[0]
        ords, scores = bm25.top(query, 100)
        assert [d for d, _ in hits] == [system.docs[o][0] for o in ords]
        assert np.allclose([s for _, s in hits], scores, rtol=1e-5)
        docids = [d for d, _ in hits[:7]]
        batch = system.svc.rerank_batch("q", query, docids)
        ids, mask, seg = plain.passage_inputs(query, [dict(system.docs)[d] for d in docids], config["extractor"])
        assert np.array_equal(batch["pos_bert_input"], ids.numpy())
        assert np.array_equal(batch["pos_mask"], mask.numpy())
        assert np.array_equal(batch["pos_seg"], seg.numpy())


@pytest.mark.parametrize("name,first,factor", [("maxp-int8-rerank", "int4", 10.0), ("colbert-bf16-b64", "int8", 100.0),
                                               ("colbert-int8-b64", "int4", 10.0), ("maxp-train", "tf32", 100.0)])
def test_the_control_reads_far_above_the_program(bench, cpu_cache, name, first, factor):
    """The control one precision down reads far above the program; every other
    control (the f32 products at TF32) gives a reading."""
    import control

    w = registry.workload(bench, name)
    r = control.readings(bench, w, SEED, 1.0, "cpu", str(cpu_cache), scale=tiny_scale(name))
    assert r["failed"] == 0 and r["correct"]
    assert list(r["controls"])[0] == first
    assert max(r["controls"][first][k] / max(factor * v, 1e-5) for k, v in r["program"].items()) > 1.0, r
    assert all(np.isfinite(v) and v >= 0 for c in r["controls"].values() for v in c.values()), r


def bump_first_score(system):
    """A score altered where it is produced: the reranker's or the engine's first score, +1."""
    svc = system.svc
    if hasattr(svc, "reranker"):
        test = svc.reranker.test

        def altered(batch, device):
            s = test(batch, device).clone()
            s[0] += 1.0
            return s

        svc.reranker.test = altered
    else:
        topk, *rest = svc._served

        def altered_topk(q, *corpus):
            scores, ords = topk(q, *corpus)
            scores = scores.clone()
            scores[:, 0] += 1.0
            return scores, ords

        svc._served = (altered_topk, *rest)


def half_the_batch(system):
    """Half of each request's queries left out."""
    dispatch = system.dispatch
    system.dispatch = lambda payload: dispatch(payload[:len(payload) // 2])


def state_unchanged(system):
    """A training step that leaves the model and the optimizer's state as they were."""
    system.trainer.optimizer_step = lambda optimizer, step: None


def half_the_triples(system):
    """Half of each training batch left out, the loss the mean over the rest."""
    train_step = system.trainer.train_step

    def half(reranker, model, optimizer, batches, step, seed):
        rows = next(iter(batches.values())).shape[1] // 2
        return train_step(reranker, model, optimizer, {k: v[:, :rows] for k, v in batches.items()}, step, seed)

    system.trainer.train_step = half


def bump_the_loss(system):
    """A step's loss altered where it is produced, +1."""
    train_step = system.trainer.train_step
    system.trainer.train_step = lambda *args: train_step(*args) + 1.0


@pytest.mark.parametrize("name,fault", [("maxp-int8-rerank", bump_first_score), ("colbert-bf16-b64", bump_first_score),
                                        ("colbert-bf16-b64", half_the_batch), ("colbert-int8-b64", bump_first_score),
                                        ("colbert-int8-b64", half_the_batch), ("maxp-train", state_unchanged),
                                        ("maxp-train", half_the_triples), ("maxp-train", bump_the_loss)])
def test_a_fault_in_the_timed_path_is_not_correct(bench, cpu_cache, name, fault):
    result = tiny_run(bench, name, cpu_cache, patch=fault)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["maxp-int8-rerank", "colbert-bf16-b64", "colbert-int8-b64", "maxp-train"])
def test_a_cell_runs_correct_on_the_card(bench, tmp_path, name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    w = registry.workload(bench, name)
    bench_run.cache_dirs(registry.ROOT)
    result = bench_run.run_cell(bench, w, SEED, 3.0, 1, "cuda", str(tmp_path))
    assert result["correct"] and result["device"]["busy_s"] > 0, result["checks"]
