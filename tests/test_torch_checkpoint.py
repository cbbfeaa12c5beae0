"""The port's checkpoint reader (``capreolus_tpu_torch/reranker/bert/checkpoint.py``)
against the JAX package, which reads through ``transformers``, on the CPU:
directories that each test writes with ``transformers`` and seeded random
weights, as ``model.safetensors`` and as ``pytorch_model.bin``.

- ``load_pretrained_encoder``: the config and every weight equal to the JAX
  function's params (exactly: both copy the same f32 values).
- ``load_pretrained_nsp_head``: equal to JAX's, and a Birch passage score over
  the loaded weights equal to ``BertForNextSentencePrediction``'s logit 1 on
  the same input (1e-5: f32 sums in another order), never ``logit 0 - logit
  1``.
- the hub cache's snapshot of a name, and an alias, resolve with no download.
- ``read_safetensors`` equal to the ``safetensors`` package's reader, bit for
  bit, in every dtype a checkpoint may hold.
"""

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu.load_all_modules()
capreolus_tpu_torch.load_all_modules()
torch.set_num_threads(2)

from capreolus_tpu.reranker.bert import load_pretrained_encoder as jax_load_pretrained_encoder  # noqa: E402
from capreolus_tpu.reranker.bert.encoder import load_pretrained_nsp_head as jax_load_nsp_head  # noqa: E402
from capreolus_tpu_torch.convert import bert_state_dict, flatten_tree  # noqa: E402
from capreolus_tpu_torch.core import ConfigError  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as TorchReranker  # noqa: E402
from capreolus_tpu_torch.reranker.bert import (load_pretrained_encoder, load_pretrained_nsp_head,  # noqa: E402
                                               nsp_logits_to_relevance_head)
from capreolus_tpu_torch.reranker.bert import checkpoint  # noqa: E402
from test_torch_bert import EXTRACTOR_TINY, OFFLINE_TOKENIZER, bert_batch  # noqa: E402

HF_TOL = 1e-5
TINY_HF = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
               max_position_embeddings=128, type_vocab_size=2)


def write_nsp_checkpoint(directory, safe, seed=0):
    """A tiny ``BertForNextSentencePrediction`` with seeded random weights, saved by ``transformers``."""
    from transformers import BertConfig as HFBertConfig
    from transformers import BertForNextSentencePrediction

    torch.manual_seed(seed)
    model = BertForNextSentencePrediction(HFBertConfig(**TINY_HF)).eval()
    with torch.no_grad():  # biases and LayerNorms away from their init, so a mapping fault shows
        for name, p in model.named_parameters():
            if name.endswith("bias") or "LayerNorm" in name:
                p.add_(torch.randn(p.shape) * 0.05)
    model.save_pretrained(str(directory), safe_serialization=safe)
    return model


def jax_encoder_state(params):
    """The JAX encoder's param tree as the port's ``BertEncoder`` state_dict."""
    state = bert_state_dict({f"params/bert/{k}": np.asarray(v) for k, v in flatten_tree(params).items()})
    return {k[len("bert."):]: v for k, v in state.items()}


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model.bin"])
def test_load_pretrained_encoder_equals_jax(tmp_path, safe):
    write_nsp_checkpoint(tmp_path, safe)
    assert (tmp_path / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    jax_cfg, jax_params = jax_load_pretrained_encoder(str(tmp_path))
    cfg, state = load_pretrained_encoder(str(tmp_path))
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size", "max_position",
                  "type_vocab_size"):
        assert getattr(cfg, field) == getattr(jax_cfg, field), field
    want = jax_encoder_state(jax_params)
    assert set(state) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(state[key].numpy(), value.numpy(), err_msg=key)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "pytorch_model.bin"])
def test_nsp_head_equals_jax_and_scores_as_logit_one(tmp_path, safe):
    hf = write_nsp_checkpoint(tmp_path, safe, seed=1)
    want = jax_load_nsp_head(str(tmp_path))
    got = load_pretrained_nsp_head(str(tmp_path))
    assert got["kernel"].shape == (64, 1) and got["bias"].shape == (1,)
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)

    # a passage's Birch score over the loaded checkpoint is the HF model's logit 1
    rr = TorchReranker.create("birch", {"pretrained": str(tmp_path), "gelu": "erf", "extractor": dict(
        EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, index={"collection": {"name": "dummy"}})})
    model = rr.build_model().eval()
    batch = bert_batch(4, 1, 32, qlen=4, seed=2, vocab=1024)
    ids, mask, seg = (torch.from_numpy(batch[k][:, 0]) for k in ("pos_bert_input", "pos_mask", "pos_seg"))
    with torch.inference_mode():
        score = model.relevance(model.bert(ids, mask, seg)[1])[:, 0].numpy()
        logits = hf(input_ids=ids, attention_mask=mask, token_type_ids=seg).logits.numpy()
    np.testing.assert_allclose(score, logits[:, 1], rtol=HF_TOL, atol=HF_TOL)
    assert not np.allclose(score, logits[:, 0] - logits[:, 1], atol=1e-3)


def test_nsp_logits_to_relevance_head_keeps_row_one():
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.asarray([5.0, -7.0], np.float32)
    head = nsp_logits_to_relevance_head(w, b)
    np.testing.assert_array_equal(head["kernel"][:, 0], w[1])
    np.testing.assert_array_equal(head["bias"], [-7.0])
    from capreolus_tpu.reranker.bert.encoder import nsp_logits_to_relevance_head as jax_head

    want = jax_head(w, b)
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(head[key], want[key])


def test_hub_cache_snapshot_and_alias_resolve_offline(tmp_path, monkeypatch):
    """A snapshot under ``$HF_HOME/hub`` is found by its name and by the
    reference's alias (``msmarco_mb``), the revision ``refs/main`` names first."""
    repo = tmp_path / "hf" / "hub" / "models--Capreolus--birch-bert-large-msmarco_mb"
    write_nsp_checkpoint(repo / "snapshots" / "abc123", safe=True, seed=3)
    write_nsp_checkpoint(repo / "snapshots" / "zzz999", safe=False, seed=4)
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("abc123")
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    assert checkpoint.find_checkpoint("Capreolus/birch-bert-large-msmarco_mb") == repo / "snapshots" / "abc123"
    cfg, state = load_pretrained_encoder("msmarco_mb")
    assert cfg.hidden_size == 64 and state is not None
    want = checkpoint.read_safetensors(repo / "snapshots" / "abc123" / "model.safetensors")
    np.testing.assert_array_equal(state["word_embeddings"].numpy(),
                                  want["bert.embeddings.word_embeddings.weight"].numpy())
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "elsewhere"))
    with pytest.raises(FileNotFoundError, match="never downloads"):
        checkpoint.find_checkpoint("Capreolus/birch-bert-large-msmarco_mb")
    with pytest.raises(RuntimeError, match="refusing to continue with random initialization"):
        load_pretrained_encoder("msmarco_mb")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int8,
                                   torch.bool, torch.float64])
def test_read_safetensors_equals_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file

    gen = torch.Generator().manual_seed(5)
    tensors = {"a.weight": (torch.randn(3, 5, generator=gen) * 100).to(dtype),
               "b": (torch.randn(7, generator=gen) * 100).to(dtype), "empty": torch.zeros(0, 4, dtype=dtype),
               "scalar": torch.ones((), dtype=dtype)}
    save_file(tensors, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    got, want = checkpoint.read_safetensors(tmp_path / "x.safetensors"), load_file(str(tmp_path / "x.safetensors"))
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key


def test_a_truncated_safetensors_file_raises(tmp_path):
    from safetensors.torch import save_file

    save_file({"w": torch.ones(64)}, str(tmp_path / "x.safetensors"))
    data = (tmp_path / "x.safetensors").read_bytes()
    (tmp_path / "x.safetensors").write_bytes(data[:-8])
    with pytest.raises(ValueError, match="spans bytes"):
        checkpoint.read_safetensors(tmp_path / "x.safetensors")


def test_moe_refuses_a_loaded_dense_checkpoint_as_jax(tmp_path):
    write_nsp_checkpoint(tmp_path, safe=True)
    cfg = {"pretrained": str(tmp_path), "moeexperts": 2, "extractor": dict(
        EXTRACTOR_TINY, tokenizer=OFFLINE_TOKENIZER, index={"collection": {"name": "dummy"}})}
    from capreolus_tpu.core import ConfigError as JaxConfigError
    from capreolus_tpu.reranker import Reranker as JaxReranker

    with pytest.raises(JaxConfigError) as jax_err:
        JaxReranker.create("BERTMaxP", cfg).build_model()
    with pytest.raises(ConfigError) as port_err:
        TorchReranker.create("BERTMaxP", cfg).build_model()
    assert str(port_err.value) == str(jax_err.value)
