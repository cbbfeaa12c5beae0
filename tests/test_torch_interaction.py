"""The interaction models of the port (``reranker/interaction.py``: TFKNRM,
DRMM, DRMMTKS, ConvKNRM, PACRR, DSSM, CDSSM) against the JAX package on the
CPU, from the JAX init carried across by ``convert.py``: ``test`` scores
within 1e-5, the deterministic pairwise-hinge gradients within 1e-4 of each
tensor's largest entry, three Adam steps on the same gradients within 1e-4 of
the learning rate (``tests/torch_zoo_util.py``). DRMM's histogram edges and
counts equal JAX's exactly; the even-kernel ``SAME`` padding and the
converter's shape checks are held on their own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capreolus_tpu.reranker import interaction as jax_interaction
from capreolus_tpu_torch.convert import flax_flat_params, flax_state_dict
from capreolus_tpu_torch.reranker import interaction
from capreolus_tpu_torch.reranker.common import conv_same, same_padding
from torch_zoo_util import (EXACT_MATCH_KERNEL, ZooCase, case_id, check_adam_steps, check_forward, check_gradients,
                            zoo_corpus)  # noqa: F401

torch.set_num_threads(2)

CASES = (
    [("TFKNRM", {"gradkernels": False, "finetune": False}), ("TFKNRM", {})]
    + [("DRMM", {"histType": h, "gateType": g}) for h in ("CH", "NH", "LCH") for g in ("IDF", "TV")]
    + [("DRMMTKS", {}), ("DRMMTKS", {"gateType": "TV", "topk": 30})]
    + [("ConvKNRM", {"crossmatch": c, "singlefc": s, "filters": 6}) for c in (True, False) for s in (True, False)]
    + [("PACRR", {"mingram": 1, "maxgram": 3, "nfilters": 4}), ("PACRR", {"mingram": 2, "maxgram": 3, "idf": False}),
       ("PACRR", {"mingram": 3, "maxgram": 3, "nonlinearity": "tanh"}),
       ("PACRR", {"mingram": 2, "maxgram": 2, "nonlinearity": "none", "kmax": 3})]
    + [("DSSM", {"extractor": {"datamode": "unigram"}}), ("DSSM", {"extractor": {"datamode": "trigram"}}),
       ("DSSM", {"nhiddens": "12 7", "extractor": {"datamode": "trigram"}})]
    + [("CDSSM", {}), ("CDSSM", {"nfilter": 5, "windowsize": 2, "dropoutrate": 0.3})]
)
_CACHE = {}


def jax_pacrr_without_nonlinearity(jax_rr):
    """The JAX PACRR model with ``nonlinearity="none"``: the config reads
    "none" as None, which the JAX model's table lacks (ROADMAP.md, "Reference
    fault"), so its reranker cannot build it."""
    c = jax_rr.config
    return jax_interaction.PACRRModel(embedding_init=jax_rr.extractor.embeddings, mingram=c["mingram"],
                                      maxgram=c["maxgram"], nfilters=c["nfilters"], kmax=c["kmax"],
                                      combine=c["combine"], nonlinearity="none", use_idf=c["idf"])


def zoo_case(corpus, case):
    if case_id(case) not in _CACHE:
        name, options = case
        # ConvKNRM: flax draws the conv biases 0, so a pad window's n-gram is the zero vector, and JAX's
        # gradient of its norm there is NaN (ROADMAP.md, "Reference fault"); held from nonzero biases
        # DRMM: the histogram is a step function of the similarities (a self-similarity an ulp either side
        # of the last edge, 1.0, moves a count), held where both packages' similarities are bit-identical
        none = name == "PACRR" and options.get("nonlinearity") == "none"
        _CACHE[case_id(case)] = ZooCase(corpus, name, options, perturb_biases=name == "ConvKNRM",
                                        dyadic_embedding=name == "DRMM",
                                        jax_model=jax_pacrr_without_nonlinearity if none else None)
    return _CACHE[case_id(case)]


def exclusions(case):
    name, options = case
    if options.get("gradkernels", True) and name in ("TFKNRM", "ConvKNRM"):
        return {"params/mus": [EXACT_MATCH_KERNEL], "params/sigmas": [EXACT_MATCH_KERNEL]}
    return None


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_matches_jax(zoo_corpus, case):
    c = zoo_case(zoo_corpus, case)
    assert set(flax_flat_params(c.model)) == set(c.init), "the port's parameters are the JAX tree's leaves"
    check_forward(c)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_match_jax(zoo_corpus, case):
    check_gradients(zoo_case(zoo_corpus, case), exclude=exclusions(case))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_adam_steps_match_jax(zoo_corpus, case):
    check_adam_steps(zoo_case(zoo_corpus, case))


@pytest.mark.parametrize("nbins", [range(1, 41), (50, 64, 99, 100, 128, 200, 255, 256, 300, 333, 351)],
                         ids=["1-40", "50-351"])
def test_histogram_edges_equal_jax(nbins):
    """Above 351 bins XLA's CPU code rounds otherwise (ROADMAP.md, "Recorded differences")."""
    for n in nbins:
        want = np.asarray(jnp.linspace(-1.0, 1.0, n + 1)[1:])
        got = interaction.histogram_edges(n)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=f"nbins {n}")


@pytest.mark.parametrize("hist_type", ["CH", "NH", "LCH"])
def test_matching_histogram_equals_jax(hist_type):
    """Counts equal JAX's exactly, with similarities on the bin edges, at the
    exact-match bin's bounds and at pad positions."""
    nbins = 29
    edges = interaction.histogram_edges(nbins)
    rng = np.random.Generator(np.random.PCG64(4))
    sim = rng.uniform(-1.0, 1.0, size=(3, 4, 40)).astype(np.float32)
    sim[0, 0, :nbins] = edges  # exactly on every upper edge
    sim[0, 1, :6] = np.float32([0.999, 1.001, 1.0, np.nextafter(np.float32(0.999), 2), -1.0, 0.0])
    sim[1, 2, :5] = np.nextafter(edges[:5], np.float32(-2))  # just below the edges
    d_mask = (rng.random((3, 40)) < 0.8).astype(np.float32)
    want = np.asarray(jax_interaction.matching_histogram(jnp.asarray(sim), jnp.asarray(d_mask), nbins, hist_type))
    got = interaction.matching_histogram(torch.from_numpy(sim), torch.from_numpy(d_mask), nbins, hist_type).numpy()
    np.testing.assert_array_equal(got, want)
    if hist_type == "CH":
        assert got[0, 0, :nbins].min() >= 1 and got[0, 1, -1] == 1 + 2  # 0.999 < sim < 1.001: 1.0 and its neighbour


def test_matching_histogram_takes_no_gradient():
    sim = torch.rand(2, 3, 8, requires_grad=True)
    assert not interaction.matching_histogram(sim, torch.ones(2, 8), 5, "LCH").requires_grad


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_same_padding_of_even_kernels_matches_flax(k):
    """flax ``nn.Conv(padding="SAME")`` at kernel 1-4, 1-D and 2-D (an even
    kernel pads 0 before and 1 after, as XLA does), through the converter's
    layouts: flax's channels-last kernel onto torch's channels-first one."""
    import flax.linen as fnn
    import jax

    rng = np.random.Generator(np.random.PCG64(k))
    x1 = rng.standard_normal((2, 7, 3)).astype(np.float32)  # [B, L, C]
    x2 = rng.standard_normal((2, 5, 6, 1)).astype(np.float32)  # [B, H, W, C]
    for x, size, conv in ((x1, (k,), torch.nn.Conv1d(3, 4, k)), (x2, (k, k), torch.nn.Conv2d(1, 4, (k, k)))):
        module = fnn.Conv(4, kernel_size=size, padding="SAME")
        params = module.init(jax.random.PRNGKey(k), jnp.asarray(x))
        params = jax.tree_util.tree_map(lambda v: v + 0.1, params)  # nonzero biases
        want = np.asarray(module.apply(params, jnp.asarray(x)))
        flat = {f"params/{key}": np.asarray(v) for key, v in params["params"].items()}
        conv.load_state_dict(flax_state_dict(conv, flat))
        with torch.no_grad():
            got = conv_same(conv, torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert same_padding(k) == ((k - 1) // 2, k - 1 - (k - 1) // 2)


def test_converter_checks_every_shape():
    model = interaction.PACRRModel(np.zeros((5, 8), np.float32), maxqlen=4, maxdoclen=24)
    flat = flax_flat_params(model)
    assert flat["params/conv_2/kernel"].shape == (2, 2, 1, 32) and flat["params/combine1/kernel"].shape == (28, 32)
    with pytest.raises(ValueError, match="combine1/kernel"):
        flax_state_dict(model, dict(flat, **{"params/combine1/kernel": np.zeros((36, 32), np.float32)}))
    with pytest.raises(KeyError, match="conv_9"):
        flax_state_dict(model, dict(flat, **{"params/conv_9/kernel": np.zeros(1, np.float32)}))


def test_sizes_follow_the_extractor_config(zoo_corpus):
    """flax sizes its layers from the first batch; the port from the extractor."""
    pacrr = zoo_case(zoo_corpus, ("PACRR", {"mingram": 1, "maxgram": 3, "nfilters": 4})).model
    assert pacrr.combine1.in_features == 4 * ((3 - 1 + 1) * 2 + 1)
    conv = zoo_case(zoo_corpus, ("ConvKNRM", {"crossmatch": True, "singlefc": True, "filters": 6}))
    assert conv.model.combine.in_features == 11 * 3 * 3
    assert zoo_case(zoo_corpus, ("ConvKNRM", {"crossmatch": False, "singlefc": True, "filters": 6})
                    ).model.combine.in_features == 11 * 3
    dssm = zoo_case(zoo_corpus, ("DSSM", {"extractor": {"datamode": "unigram"}}))
    assert dssm.model.ffw_0.in_features == dssm.port_rr.extractor.feature_dim == max(1, len(dssm.port_rr.extractor.stoi))
    assert dssm.batches[0]["query"].shape[1] == dssm.model.ffw_0.in_features


def test_frozen_tfknrm_is_the_ports_knrm_over_slowembedtext(zoo_corpus):
    from capreolus_tpu_torch.reranker.knrm import KNRMModel

    c = zoo_case(zoo_corpus, ("TFKNRM", {"gradkernels": False, "finetune": False}))
    assert isinstance(c.model, KNRMModel) and c.port_rr.extractor.module_name == "slowembedtext"
    assert not c.model.mus.requires_grad and not c.model.embedding.requires_grad  # K1's condition on the card


def test_dropout_sites_are_seeded_per_site(zoo_corpus):
    """DSSM's 0.5 between its layers and CDSSM's convolution dropout: a seed
    gives the same scores twice, another seed others, no seed the test forward."""
    for case in (("DSSM", {"extractor": {"datamode": "unigram"}}),
                 ("CDSSM", {"nfilter": 5, "windowsize": 2, "dropoutrate": 0.3})):
        c = zoo_case(zoo_corpus, case)
        batch = c.batches[0]
        with torch.no_grad():
            a = torch.stack(c.port_rr.score(batch, "cpu", dropout_seed=3))
            b = torch.stack(c.port_rr.score(batch, "cpu", dropout_seed=3))
            other = torch.stack(c.port_rr.score(batch, "cpu", dropout_seed=4))
            plain = torch.stack(c.port_rr.score(batch, "cpu"))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, other) and not torch.equal(a, plain)
        np.testing.assert_allclose(plain[0].numpy(), c.port_test(batch), rtol=0, atol=0)
