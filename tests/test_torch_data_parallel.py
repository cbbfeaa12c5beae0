"""The port's data parallelism (``trainer/torch_trainer.py``'s ``_mesh`` and
``parallel/placement.py``) against the JAX trainer's, on the CPU: the port
over the device list ``["cpu"] * 8``, JAX over its 8 forced host devices.

- ``_mesh`` builds JAX's meshes: every device on ``data`` while the batch
  divides, the data axis shrinking until it does, None on one device;
- KNRM trains with batch 8 over 8 data shards (``tests/test_parallel.py``'s
  case) and validates;
- tiny BERT-MaxP's losses over 8 data shards equal the port's on one device
  and the JAX trainer's from the same init, within rtol 5e-4 / atol 1e-5;
- one step's gradients equal one device's within 1e-5, and a prediction cut
  over the data shards scores as one device does.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu_torch.convert import flax_flat_params  # noqa: E402
from capreolus_tpu_torch.trainer import Trainer as TorchTrainerBase  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from test_torch_index import torch_cache  # noqa: E402,F401
from test_torch_trainer import corpus, draw, knrm_pair, samplers  # noqa: E402,F401
from torch_parallel_common import (CPU8, FWD_TOL, assert_losses, bert_pair, carry_init, train_jax,  # noqa: E402
                                   train_port)


@pytest.mark.parametrize("batch,devices,want", [
    (8, CPU8, {"data": 8}), (6, CPU8, {"data": 6}), (7, CPU8, {"data": 7}), (5, ["cpu"] * 4, None),
    (8, ["cpu"], None), (4, ["cpu"] * 2, {"data": 2}),
])
def test_mesh_is_jax_data_mesh(corpus, batch, devices, want):
    """The data axis takes every device while the batch divides, and shrinks
    until it does; one device (or a batch no count above 1 divides) is no mesh."""
    _, port_rr = knrm_pair(corpus, trainer={"batch": batch})
    port_rr.trainer.device, port_rr.trainer.devices = "cpu", devices
    mesh = port_rr.trainer._mesh(batch)
    assert (None if mesh is None else mesh.shape) == want


def test_data_parallel_training_runs(corpus, tmp_path):
    """KNRM with batch=8 sharded over the 8-device list: dev.best, the loss
    file and validation metrics, as tests/test_parallel.py asks of JAX."""
    _, port_rr = knrm_pair(corpus, trainer={"niters": 1, "itersize": 16, "batch": 8, "validatefreq": 1})
    losses, metrics = train_port(port_rr, corpus, tmp_path)
    trainer = port_rr.trainer
    assert (tmp_path / "train" / "dev.best.params").exists()
    assert (tmp_path / "train" / "info" / "loss.txt").exists()
    assert trainer._data_mesh is not None and trainer._data_mesh.devices.size == 8
    assert trainer._placement.kind == "dp" and metrics["map"] > 0 and np.isfinite(losses).all()


def test_bert_data_parallel_losses_match_one_device_and_jax(corpus, tmp_path):
    jax_rr, port_rr = bert_pair(corpus, {})
    carry_init(jax_rr, port_rr, corpus)
    mesh_losses, mesh_metrics = train_port(port_rr, corpus, tmp_path / "dp")
    assert dict(port_rr.trainer._data_mesh.shape) == {"data": 8}
    _, one_rr = bert_pair(corpus, {})
    carry_init(jax_rr, one_rr, corpus)
    one_losses, one_metrics = train_port(one_rr, corpus, tmp_path / "one", devices=None)
    assert one_rr.trainer._data_mesh is None
    assert_losses(mesh_losses, one_losses, "dp=8 against one device")
    np.testing.assert_allclose(mesh_metrics["map"], one_metrics["map"], rtol=1e-5)
    assert_losses(mesh_losses, train_jax(jax_rr, corpus, tmp_path / "jax"), "dp=8 against the JAX trainer")


def test_data_parallel_step_gradients_and_predictions_equal_one_device(corpus):
    """One step's loss and each leaf's gradient over 8 data shards (summed
    back into the one replicated block) against one device; a prediction
    batch of 5 (padded to 8) cut over the shards against one device."""
    from capreolus_tpu_torch.convert import flax_leaves
    from capreolus_tpu_torch.parallel.placement import Placement

    _, port_rr = bert_pair(corpus, {"batch": 8})
    trainer = port_rr.trainer
    trainer.device, trainer.devices = "cpu", CPU8
    samples = draw(samplers(corpus, (port_rr, port_rr))[1], 8)
    micro = collate(samples, ARRAY_KEYS)
    model = port_rr.init_params(0)
    trainer.make_optimizer(port_rr, model)
    loss = trainer.compute_loss(port_rr, micro, torch.device("cpu"))
    loss.backward()
    want = {key: param.grad for key, name, *_ in flax_leaves(model) for n, param in model.named_parameters()
            if n == name}
    trainer._data_mesh = trainer._mesh(8)
    trainer._placement = placement = Placement(model, trainer._data_mesh, "dp")
    with placement.bind():
        got = trainer.mesh_loss(port_rr, micro)
        got.backward()
    assert abs(float(got.detach()) - float(loss.detach())) <= FWD_TOL * max(1.0, abs(float(loss.detach())))
    for key, (name, to_flax, _) in placement.leaves.items():
        (block,) = placement.store[key].blocks.values()
        ref = to_flax(want[key])
        scale = max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(block.grad / scale, ref / scale, rtol=0, atol=FWD_TOL, msg=key)

    pred = samplers(corpus, (port_rr, port_rr), "pred")[1]
    trainer._model = model
    batch = collate(draw(pred, 5), ARRAY_KEYS)
    with torch.no_grad():
        ref = port_rr.test(batch, torch.device("cpu"))
    trainer.config["evalbatch"] = 5
    preds = trainer.predict(port_rr, pred)
    got = [preds[s["qid"]][s["posdocid"]] for s in draw(pred, 5)]
    np.testing.assert_allclose(got, ref.numpy(), rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("name", ["knrm-dp8", "bert-pp2"])
def test_fastforward_on_a_mesh_equals_an_uninterrupted_run(corpus, tmp_path, name):
    """A run cut after 2 of 3 iterations and resumed from its flat per-iteration
    checkpoints (the weights onto the placement's layout, pp's stacked
    leaves included, and Adam's state by leaf) ends with the loss history and
    weights of a run of 3, on the 8-device list."""
    cfg = {"niters": 3, "itersize": 8, "batch": 8, "lr": 0.05, "fastforward": True}

    def pair(niters):
        if name == "knrm-dp8":
            return knrm_pair(corpus, trainer=dict(cfg, niters=niters), finetune=True)[1]
        return bert_pair(corpus, dict(cfg, niters=niters, pp=2, bertlr=1e-3))[1]

    full = pair(3)
    train_port(full, corpus, tmp_path / "full", dev=False)
    train_port(pair(2), corpus, tmp_path / "resumed", dev=False)
    resumed = pair(3)
    steps, step = [], resumed.trainer.train_step
    resumed.trainer.train_step = lambda *a, **kw: steps.append(1) or step(*a, **kw)
    want = train_port(resumed, corpus, tmp_path / "resumed", dev=False)[0]
    assert len(steps) == 1, "the resumed run trained more than its last iteration"
    assert want == TorchTrainerBase.load_loss_file(tmp_path / "full" / "train" / "info" / "loss.txt")
    assert resumed.trainer._placement.kind == ("dp" if name == "knrm-dp8" else "pp")
    a, b = flax_flat_params(full.build_train_model()), flax_flat_params(resumed.build_train_model())
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-7, err_msg=key)
