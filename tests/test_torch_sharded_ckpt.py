"""The write side of the PyTorch port's sharded checkpoints
(``utils/sharded_ckpt.py``) and the trainer's ``ckpt=sharded|sharded_async``,
against the JAX package's ``utils/sharded_ckpt.py`` and the port's flat
checkpoints, on the CPU.

- a port-written ``<path>.params.shards`` read by JAX's ``restore_params`` and
  ``load_sharded`` equals the port's flat ``<path>.params`` leaves bit for
  bit; the port's ``load_sharded`` reads back what it wrote (numpy or torch,
  bf16 included) and a directory JAX wrote from arrays sharded over its
  8-device mesh (assembled by global index ranges);
- resuming from ``sharded`` and from ``sharded_async`` equals resuming from
  ``flat``, bit for bit, after one more step (weights and Adam state);
- ``<path>.done`` appears only after both trees are on disk.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.utils import sharded_ckpt as jax_ckpt  # noqa: E402
from capreolus_tpu.utils.sharded_ckpt import load_sharded as jax_load_sharded  # noqa: E402
from capreolus_tpu.utils.sharded_ckpt import restore_params as jax_restore_params  # noqa: E402
from capreolus_tpu_torch.convert import flatten_tree  # noqa: E402
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate  # noqa: E402
from capreolus_tpu_torch.utils import sharded_ckpt  # noqa: E402
from capreolus_tpu_torch.utils.flax_msgpack import from_bytes  # noqa: E402
from test_torch_trainer import bert_pair, corpus, draw, samplers  # noqa: E402,F401
from test_torch_index import torch_cache  # noqa: E402,F401


def trained_pair(corpus, ckpt):
    """A tiny BERT-MaxP reranker under ``trainer.ckpt=ckpt``, its training
    model and Adam after one step, and the step's batch."""
    _, port_rr = bert_pair(corpus, trainer={"niters": 1, "itersize": 4, "batch": 4, "ckpt": ckpt})
    port_rr.trainer.device = "cpu"
    samples = draw(samplers(corpus, (port_rr, port_rr))[1], 4)
    batch = {k: v[None] for k, v in collate(samples, ARRAY_KEYS).items()}
    model = port_rr.init_params(0)
    optimizer = port_rr.trainer.make_optimizer(port_rr, model)
    port_rr.trainer.train_step(port_rr, model, optimizer, batch, 0, 0)
    return port_rr, model, optimizer, batch


def assert_trees_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, key)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {key}")


def test_port_sharded_params_read_by_jax_equal_the_flat_leaves(corpus, tmp_path):
    flat_rr, model, optimizer, _ = trained_pair(corpus, "flat")
    flat_rr.trainer.save_checkpoint(tmp_path / "flat", model, optimizer, flat_rr)
    want = flatten_tree(from_bytes((tmp_path / "flat.params").read_bytes()))
    sharded_rr = bert_pair(corpus, trainer={"ckpt": "sharded"})[1]
    written = sharded_rr.trainer.save_checkpoint(tmp_path / "sh", model, optimizer, sharded_rr)
    pdir = tmp_path / "sh.params.shards"
    assert (pdir / "manifest.json").exists() and (pdir / "done").exists() and (tmp_path / "sh.done").exists()
    assert written >= sum(np.asarray(v).nbytes for v in want.values())
    frozen = [k for k, v in want.items() if np.asarray(v).size == 0]
    assert_trees_equal(flatten_tree(jax_restore_params(pdir)), want, "JAX restore_params")
    tree = jax_restore_params(pdir)
    assert_trees_equal(flatten_tree(jax_load_sharded(pdir, like=tree)), want, "JAX load_sharded")
    assert_trees_equal(flatten_tree(sharded_ckpt.load_sharded(pdir)), want, "the port's load_sharded")
    on_device = sharded_ckpt.load_sharded(pdir, like=tree, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in flatten_tree(on_device).values())
    assert_trees_equal({k: v.numpy() for k, v in flatten_tree(on_device).items()}, want, "load_sharded on a device")
    assert not frozen or all(want[k].shape == (0,) for k in frozen)


def test_port_tree_round_trips_and_refuses_a_drifted_template(tmp_path):
    tree = {"b": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3), "h": torch.tensor([1.5, -2.0]).bfloat16()},
            "a": [np.arange(4, dtype=np.int64), np.float32(3.0)], "c": np.zeros(0, np.float32)}
    sharded_ckpt.save_sharded(tmp_path / "t", tree)
    manifest = (tmp_path / "t" / "manifest.json").read_text()
    assert '"path": "a/0"' in manifest and '"dtype": "bfloat16"' in manifest
    back = sharded_ckpt.load_sharded(tmp_path / "t", like=tree, device="cpu")
    assert back["b"]["h"].dtype == torch.bfloat16 and torch.equal(back["b"]["h"], tree["b"]["h"])
    assert torch.equal(back["b"]["w"], tree["b"]["w"]) and back["a"][0].tolist() == [0, 1, 2, 3]
    assert float(back["a"][1]) == 3.0 and back["c"].shape == (0,)
    want = jax_load_sharded(tmp_path / "t", like=jax.tree_util.tree_map(np.asarray, {
        "a": [np.zeros(4), np.float32(0)], "b": {"h": np.zeros(2), "w": np.zeros((2, 3))}, "c": np.zeros(0)}))
    np.testing.assert_array_equal(np.asarray(want["b"]["h"], np.float32), [1.5, -2.0])  # JAX reads the bf16 bits
    with pytest.raises(ValueError, match="leaf order mismatch"):
        sharded_ckpt.load_sharded(tmp_path / "t", like={"a": [0, 0], "b": {"h": 0, "x": 0}, "c": 0})
    with pytest.raises(ValueError, match="has 5 leaves; the template tree has 1"):
        sharded_ckpt.load_sharded(tmp_path / "t", like={"a": 0})


def test_jax_sharded_directory_loads_in_the_port(tmp_path):
    """A JAX checkpoint of arrays sharded 8 and 4 ways (one file per shard)
    loads in the port by global index ranges, bf16 widened to f32."""
    rng = np.random.Generator(np.random.PCG64(17))
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("x", "y"))
    host = {"kernel": rng.standard_normal((16, 6)).astype(np.float32),
            "bias": rng.standard_normal(8).astype(np.float32),
            "emb": rng.standard_normal((8, 4)).astype(np.float32)}
    tree = {"kernel": jax.device_put(host["kernel"], NamedSharding(mesh, P(("x", "y"), None))),
            "bias": jax.device_put(host["bias"], NamedSharding(mesh, P("x"))),
            "emb": jax.device_put(jnp.asarray(host["emb"], jnp.bfloat16), NamedSharding(mesh, P(None, "y")))}
    jax_ckpt.save_sharded(tmp_path / "j", tree)
    manifest = (tmp_path / "j" / "manifest.json").read_text()
    assert manifest.count('"file"') == 8 + 4 + 2  # replicas written once
    got = sharded_ckpt.load_sharded(tmp_path / "j")
    np.testing.assert_array_equal(got["kernel"], host["kernel"])
    np.testing.assert_array_equal(got["bias"], host["bias"])
    np.testing.assert_array_equal(got["emb"], np.asarray(jnp.asarray(host["emb"], jnp.bfloat16), np.float32))
    on_device = sharded_ckpt.load_sharded(tmp_path / "j", like={k: torch.zeros(1) for k in host}, device="cpu")
    assert torch.equal(on_device["kernel"], torch.from_numpy(host["kernel"]))


@pytest.mark.parametrize("ckpt", ["sharded", "sharded_async"])
def test_resume_equals_flat_after_one_more_step(corpus, tmp_path, ckpt):
    states = {}
    for mode in ("flat", ckpt):
        rr, model, optimizer, batch = trained_pair(corpus, mode)
        rr.trainer.save_checkpoint(tmp_path / mode, model, optimizer, rr)
        fresh = rr.init_params(5)  # other weights, a fresh Adam: the load must overwrite both
        fresh_opt = rr.trainer.make_optimizer(rr, fresh)
        rr.trainer.load_checkpoint(tmp_path / mode, fresh, fresh_opt, rr)
        for (name, p), (_, q) in zip(model.named_parameters(), fresh.named_parameters()):
            assert torch.equal(p, q), (mode, name)
        rr.trainer.train_step(rr, fresh, fresh_opt, batch, 1, 1)
        states[mode] = ({k: v.detach().clone() for k, v in fresh.state_dict().items()},
                        fresh_opt.state_dict())
    (w_flat, o_flat), (w_sh, o_sh) = states["flat"], states[ckpt]
    for key in w_flat:
        assert torch.equal(w_flat[key], w_sh[key]), key
    assert o_flat["param_groups"] == o_sh["param_groups"]
    for i, st in o_flat["state"].items():
        for k, v in st.items():
            assert torch.equal(v, o_sh["state"][i][k]) and v.dtype == o_sh["state"][i][k].dtype, (i, k)


def test_done_appears_only_after_both_trees(corpus, tmp_path, monkeypatch):
    rr, model, optimizer, _ = trained_pair(corpus, "sharded_async")
    release, order = threading.Event(), []
    write = sharded_ckpt._write_blocks

    def slow_write(out_dir, *args):
        release.wait(30)
        write(out_dir, *args)
        order.append(out_dir.name)

    monkeypatch.setattr(sharded_ckpt, "_write_blocks", slow_write)
    path = tmp_path / "dev.best"
    want = flatten_tree(rr.trainer.saveable_params(rr, model))
    rr.trainer.save_checkpoint(path, model, optimizer, rr)  # returns at once: the writes wait
    done = tmp_path / "dev.best.done"
    assert not done.exists() and not (tmp_path / "dev.best.params.shards").exists()
    with torch.no_grad():  # the snapshot was taken: changes after it are not saved
        for p in model.parameters():
            p.add_(1.0)
    release.set()
    rr.trainer._wait_for_checkpoints()
    assert order == ["dev.best.params.shards", "dev.best.optstate.shards"] and done.exists()
    assert_trees_equal(flatten_tree(sharded_ckpt.load_sharded(tmp_path / "dev.best.params.shards")), want,
                       "the snapshot at save time")

    # load waits for writes in flight
    release.clear()
    rr.trainer.save_checkpoint(tmp_path / "again", model, optimizer, rr)
    threading.Timer(0.2, release.set).start()
    rr.trainer.load_checkpoint(tmp_path / "again", model, optimizer, rr)
    assert (tmp_path / "again.done").exists()
