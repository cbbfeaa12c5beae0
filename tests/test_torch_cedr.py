"""CEDR-KNRM (``CEDRKNRM`` / ``TFCEDRKNRM``) in the port against the JAX
package on the CPU: ``test`` scores over the cls modes, with and without the
hidden combine layer, trainable and constant kernels and two layer lists;
int8 scores with JAX's stats; the training forward's loss, gradients and Adam
steps from the JAX init (dropout 0). Tolerances are those of
``tests/torch_bert_rerankers_util.py``. The kernel features, which the port
sums kernel by kernel, equal the JAX model's bank summed at once, at 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capreolus_tpu.reranker.common import rbf_kernel_bank as jax_rbf_kernel_bank
from capreolus_tpu_torch.reranker.bert_rerankers import CedrKnrmModel
from test_torch_index import torch_cache  # noqa: F401
from test_torch_trainer import check_training_matches_jax, corpus, make_rerankers  # noqa: F401
from torch_bert_rerankers_util import (TRAIN_EXTRACTOR, check_int8_scores_match_jax, check_scores_match_jax,
                                       reranker_pair)

torch.set_num_threads(2)

CEDR_CASES = [
    {"cls": "avg", "combine_hidden": 1024, "gradkernels": True, "simmat_layers": "0..2,1"},
    {"cls": "max", "combine_hidden": 0, "gradkernels": True, "simmat_layers": "0,2"},
    {"cls": "none", "combine_hidden": 1024, "gradkernels": False, "simmat_layers": "0,2"},
    {"cls": "avg", "combine_hidden": 0, "gradkernels": False, "simmat_layers": "0..2,1"},
    {"cls": "max", "combine_hidden": 16, "gradkernels": True, "simmat_layers": "1"},
]


def case_id(options):
    return "-".join(f"{k}{v}" for k, v in options.items())


@pytest.mark.parametrize("options", CEDR_CASES, ids=case_id)
def test_cedr_scores_match_jax(options):
    _, port_rr = check_scores_match_jax("CEDRKNRM", options, f"CEDR-KNRM {case_id(options)}")
    model = port_rr.model
    assert isinstance(model, CedrKnrmModel)
    assert ("mus" in dict(model.named_parameters())) == options["gradkernels"]
    assert hasattr(model, "combine_hidden") == (options["combine_hidden"] > 0)


def test_tfcedrknrm_is_cedrknrm_at_the_published_defaults():
    _, port_rr = check_scores_match_jax("TFCEDRKNRM", {}, "TFCEDRKNRM defaults", seed=14, key=2)
    assert list(port_rr.config["simmat_layers"]) == list(range(13)) and port_rr.config["cls"] == "avg"
    assert port_rr.model.combine_hidden.in_features == 13 * 11 + 64


@pytest.mark.parametrize("cls", ["avg", "none"])
def test_cedr_int8_scores_match_jax(cls):
    check_int8_scores_match_jax("CEDRKNRM", {"cls": cls, "simmat_layers": "0..2,1"}, f"CEDR-KNRM int8 cls {cls}")


def test_kernel_features_equal_the_jax_bank():
    """One layer's features, kernel by kernel in the port, against the JAX
    model's whole [B, K, L, P * L] bank (its rbf_kernel_bank, summed and
    logged as CedrKnrmModel does), on similarities with masked rows."""
    jax_rr, port_rr = reranker_pair("CEDRKNRM", {"simmat_layers": "1"})
    model = port_rr.build_model()
    rng = np.random.Generator(np.random.PCG64(8))
    b, p, l = 2, 3, 16
    emb = rng.standard_normal((b * p, l, 64)).astype(np.float32)
    qd = rng.random((b * p, l, l)) < 0.6
    qd[:, :, :2] = False
    qd[:, 3] = False  # a query row without any document token
    with torch.no_grad():
        got = model.kernel_features(torch.from_numpy(emb), torch.from_numpy(qd), b, p).numpy()

    norm = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-9)
    sim = jnp.where(qd, jnp.einsum("bqe,bde->bqd", norm, norm), 0.0)
    sim = sim.reshape(b, p, l, l).transpose(0, 2, 1, 3).reshape(b, l, p * l)
    k_sum = jax_rbf_kernel_bank(sim, model.mus.detach().numpy(), model.sigmas.detach().numpy()).sum(axis=3)
    row_valid = (jnp.abs(sim).sum(axis=2) != 0.0)[:, None, :]
    want = np.asarray(jnp.where(row_valid, jnp.log(jnp.maximum(k_sum, 1e-10)) * 0.01, 0.0).sum(axis=2))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("options", [CEDR_CASES[0], CEDR_CASES[2]], ids=case_id)
def test_cedr_training_matches_jax(corpus, options):
    jax_rr, port_rr = make_rerankers(corpus, "CEDRKNRM", dict(
        options, pretrained="tiny", hidden_dropout_prob=0.0, extractor=TRAIN_EXTRACTOR,
        trainer={"batch": 2, "lr": 1e-3, "bertlr": 1e-3, "itersize": 8}))
    # with cls=none the pooler's output is not read: its JAX gradient is 0 and the port takes none
    unused = ("params/bert/pooler/kernel", "params/bert/pooler/bias") if options["cls"] == "none" else ()
    check_training_matches_jax(corpus, jax_rr, port_rr, unused=unused)


def test_cedr_kernels_train_at_lr(corpus):
    """mus and sigmas have no "bert" in their JAX paths: the trainer puts them at ``lr``."""
    _, port_rr = make_rerankers(corpus, "CEDRKNRM", {"pretrained": "tiny", "extractor": TRAIN_EXTRACTOR})
    labels = port_rr.trainer.param_labels(port_rr, port_rr.init_params(0))
    assert labels["mus"] == labels["sigmas"] == labels["combine.weight"] == "other"
    assert {labels[n] for n in labels if n.startswith("bert.")} == {"bert"}
    model = port_rr.init_params(1)  # the kernel bank starts from its configured values
    np.testing.assert_array_equal(model.mus.detach().numpy(),
                                  np.asarray([-0.9, -0.7, -0.5, -0.3, -0.1, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0], np.float32))
    np.testing.assert_array_equal(model.sigmas.detach().numpy(), np.asarray([0.1] * 10 + [0.01], np.float32))
