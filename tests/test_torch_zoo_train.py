"""The reranker zoo through the port's registry, trainer and CLI on the CPU:
every reranker and extractor the JAX package registers is created in the port
(the port's ``test_all_rerankers_creatable``); ``rerank.traineval`` through
``python -m capreolus_tpu_torch ... --device=cpu`` for one model per
extractor at tiny width; a ``dev.best`` of either trainer loads in the other
package and scores the same (within ``MSGPACK_SCORE_TOL``, 2e-4, of
``tests/test_torch_trainer.py``) for ConvKNRM and POSITDRMM, and the port's
re-save of a JAX ``dev.best`` is byte-identical."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()

from capreolus_tpu.core import module_registry as jax_registry  # noqa: E402
from capreolus_tpu.trainer.jax_trainer import collate as jax_collate  # noqa: E402
from capreolus_tpu_torch.convert import load_params  # noqa: E402
from capreolus_tpu_torch.core import module_registry as torch_registry  # noqa: E402
from capreolus_tpu_torch.extractor import Extractor  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from test_torch_bert import assert_within  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import MSGPACK_SCORE_TOL, _score_both, corpus, draw, make_rerankers, samplers  # noqa: E402,F401
from torch_zoo_util import ZOO_EXTRACTOR  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ZOO = ["TFKNRM", "DRMM", "DRMMTKS", "ConvKNRM", "PACRR", "DSSM", "CDSSM", "DUET", "POSITDRMM", "HINT", "TK",
       "DeepTileBar"]


def test_every_jax_reranker_is_created_or_names_its_roadmap_item(torch_cache):
    """Every JAX reranker is created in the port: ``biencoder``, ``unicoil``
    and ``splade`` were the last three (``tests/test_torch_dense_rerankers.py``
    holds them against JAX)."""
    names = jax_registry.get_module_names("reranker")
    assert set(ZOO) <= set(names) and set(ZOO) <= set(torch_registry.get_module_names("reranker"))
    assert set(names) <= set(torch_registry.get_module_names("reranker"))
    for name in names:
        assert Reranker.create(name, {"trainer": {"niters": 1}}).module_name == name
    assert {"biencoder", "splade", "unicoil"} <= set(torch_registry.get_module_names("reranker"))


def test_every_jax_extractor_is_created(torch_cache):
    for name in jax_registry.get_module_names("extractor"):
        assert Extractor.create(name, {"index": {"collection": {"name": "dummy"}}}).module_name == name


def test_unported_reranker_in_a_task_names_its_roadmap_item(torch_cache):
    """``splade`` was refused here until the port had it: the rerank task now
    creates it with its ``berttext`` extractor and the trainer."""
    from capreolus_tpu_torch.task import Task

    task = Task.create("rerank", {"benchmark": {"name": "dummy"}, "reranker": {"name": "splade"}})
    assert task.reranker.module_name == "splade" and task.reranker.extractor.module_name == "berttext"
    assert task.reranker.trainer.module_name == "jax" and task.reranker.config["regweight"] == 1e-3


CLI_CASES = {  # one model per extractor, at tiny width
    "DRMM": ["reranker.extractor.embeddings=random8", "reranker.extractor.maxdoclen=24"],  # embedtext
    "TK": ["reranker.extractor.embeddings=random8", "reranker.extractor.maxdoclen=24", "reranker.ffdim=8"],  # slow
    "DSSM": ["reranker.nhiddens=8"],  # bagofwords
    "DeepTileBar": ["reranker.extractor.embeddings=random8", "reranker.extractor.maxdoclen=24",
                    "reranker.extractor.slicelen=8", "reranker.extractor.passagelen=4"],  # deeptiles
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_traineval_on_the_cpu(tmp_path, name):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "CAPREOLUS_CACHE": str(tmp_path / "cache"),
           "CAPREOLUS_RESULTS": str(tmp_path / "results")}
    cmd = [sys.executable, "-m", "capreolus_tpu_torch", "rerank.traineval", "with", "benchmark.name=dummy",
           f"reranker.name={name}", *CLI_CASES[name], "reranker.trainer.niters=2", "reranker.trainer.itersize=4",
           "reranker.trainer.batch=2", "threshold=10", "testthreshold=10", "--device=cpu"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rerank: fold=s1 test metrics" in proc.stderr
    assert list((tmp_path / "results").rglob("dev.best.params"))
    assert list((tmp_path / "results").rglob("pred/test/best"))


@pytest.mark.parametrize("name,options", [("ConvKNRM", {"filters": 6}), ("POSITDRMM", {"hidden": 5})],
                         ids=["ConvKNRM", "POSITDRMM"])
def test_dev_best_crosses_both_trainers(corpus, tmp_path, name, options):
    """A dev.best written by the JAX trainer loads in the port (and the port
    writes it back byte for byte); one written by the port loads in the JAX
    trainer; each scores the candidates as the package that wrote it."""
    jax_rr, port_rr = make_rerankers(corpus, name, dict(options, extractor=dict(ZOO_EXTRACTOR)))
    samples = draw(samplers(corpus, (jax_rr, port_rr), "pred")[0], 8)
    batch = collate(samples, ARRAY_KEYS)
    template = jax_rr.init_params(jax.random.PRNGKey(5), jax_collate(samples, ARRAY_KEYS))
    template = jax.tree_util.tree_map_with_path(  # nonzero biases (ConvKNRM's n-grams of pads, see test_torch_interaction)
        lambda path, v: v + 0.05 if str(getattr(path[-1], "key", "")) == "bias" else v, template)

    jax_rr.trainer.save_checkpoint(tmp_path / "jax" / "dev.best", template, {}, jax_rr)
    port_rr.trainer.device = "cpu"
    port_rr.trainer.load_best_model(port_rr, tmp_path / "jax")
    got, want = _score_both(jax_rr, port_rr, template, batch)
    assert_within(got, want, MSGPACK_SCORE_TOL, f"{name}: JAX dev.best scored by the port")
    port_rr.trainer.save_checkpoint(tmp_path / "again" / "dev.best", port_rr.build_train_model(), None, port_rr)
    assert (tmp_path / "again" / "dev.best.params").read_bytes() == (tmp_path / "jax" / "dev.best.params").read_bytes()

    port_model = port_rr.init_params(11)
    port_rr.trainer.save_checkpoint(tmp_path / "port" / "dev.best", port_model, None, port_rr)
    flat = load_params(tmp_path / "port" / "dev.best")
    assert flat["params/embedding"].size == 0  # frozen leaves are written empty, as the JAX trainer writes them
    loaded, _ = jax_rr.trainer.load_checkpoint(tmp_path / "port" / "dev.best", template, reranker=jax_rr)
    got, want = _score_both(jax_rr, port_rr, loaded, batch)
    assert_within(got, want, MSGPACK_SCORE_TOL, f"{name}: port dev.best scored by JAX")


def test_training_steps_run_under_dropout(corpus):
    """A training step of each dropout model with the trainer's seeds moves
    its weights and leaves them finite (the masks are the port's own)."""
    for name, options in (("DUET", {"nhidden": 16}), ("TK", {"ffdim": 8}), ("DSSM", {"nhiddens": "8"})):
        extractor = {"maxqlen": 4} if name == "DSSM" else dict(ZOO_EXTRACTOR)
        pair = make_rerankers(corpus, name, dict(options, extractor=extractor, trainer={"batch": 3, "itersize": 3}))
        port_rr = pair[1]
        samples = draw(samplers(corpus, pair)[1], 3)
        batch = {k: v[None] for k, v in collate(samples, ARRAY_KEYS).items()}
        # seed 1: at seed 0 TK's init scores run ~35, and under the step's dropout masks each of the 3
        # positive docs beats its negative by more than the hinge's margin: the loss is 0, no weight moves
        model = port_rr.init_params(1)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        optimizer = port_rr.trainer.make_optimizer(port_rr, model)
        loss = port_rr.trainer.train_step(port_rr, model, optimizer, batch, 0, port_rr.trainer.step_seed(0, 0))
        assert torch.isfinite(loss) and loss > 0, name
        moved = [k for k, v in model.state_dict().items() if not torch.equal(v, before[k])]
        assert moved and all(torch.isfinite(v).all() for v in model.state_dict().values()), name
