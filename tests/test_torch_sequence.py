"""The sequence models of the port (``reranker/sequence_models.py``: DUET,
POSITDRMM, HINT spatial and windowed, TK, DeepTileBar) against the JAX
package on the CPU, from the JAX init carried across by ``convert.py``, with
``tests/torch_zoo_util.py``'s three checks (``test`` scores 1e-5, gradients
1e-4 of each tensor's scale, 3 Adam steps 1e-4 of the learning rate). Also:
the spatial GRU against the JAX module and against the numpy referee of
``tests/test_sequence_models.py``; the backward GRU's outputs at their input
positions; flax's GRU and LSTM cells against the port's recurrences; TK's
attention against flax's module; DUET's local layer with its doc positions as
channels."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capreolus_tpu.reranker import sequence_models as jax_seq
from capreolus_tpu_torch.convert import flax_flat_params, flax_state_dict, init_flax_
from capreolus_tpu_torch.core import ConfigError
from capreolus_tpu_torch.reranker import Reranker
from capreolus_tpu_torch.reranker import sequence_models as seq
from torch_zoo_util import (EXACT_MATCH_KERNEL, ZOO_EXTRACTOR, ZooCase, case_id, check_adam_steps, check_forward,
                            check_gradients, zoo_corpus)  # noqa: F401

torch.set_num_threads(2)

CASES = [
    ("DUET", {"nhidden": 40}), ("DUET", {"activation": "tanh", "idfweight": False, "nfilters": 3}),
    ("POSITDRMM", {"hidden": 6}), ("POSITDRMM", {"hidden": 5, "topk": 3}),
    ("TK", {"ffdim": 12}), ("TK", {"numattheads": 4, "numlayers": 1, "singlefc": False, "gradkernels": False}),
    ("HINT", {}), ("HINT", {"mode": "windowed"}), ("HINT", {"mode": "windowed", "spatialGRU": 1, "kmax": 3}),
    ("DeepTileBar", {}),
]
RECURRENT_TOL = 1e-5  # the cells against flax's: f32 sums in other orders over a few steps
_CACHE = {}


def zoo_case(corpus, case):
    if case_id(case) not in _CACHE:
        _CACHE[case_id(case)] = ZooCase(corpus, *case)
    return _CACHE[case_id(case)]


def exclusions(case):
    name, options = case
    if name == "TK" and options.get("gradkernels", True):
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


def test_sizes_follow_the_extractor_config(zoo_corpus):
    """DUET's local layer takes maxdoclen (24) input channels over maxqlen (4)
    positions, so a transposed layout fails the forward above; HINT's fc is
    LSTMdim x kmax wide whatever the windows; windowed HINT's combine is
    2 LSTMdim min(kmax, n_win); DeepTileBar's ffw1 maxqlen x 2 lstmhiddendim."""
    duet = zoo_case(zoo_corpus, ("DUET", {"nhidden": 40})).model
    assert duet.local_conv.in_channels == ZOO_EXTRACTOR["maxdoclen"] != ZOO_EXTRACTOR["maxqlen"]
    assert duet.local_ffw1.in_features == ZOO_EXTRACTOR["maxqlen"] * 10
    assert zoo_case(zoo_corpus, ("HINT", {})).model.fc.in_features == 6 * 10
    windowed = zoo_case(zoo_corpus, ("HINT", {"mode": "windowed", "spatialGRU": 1, "kmax": 3})).model
    assert windowed.combine.in_features == 2 * 6 * min(3, ZOO_EXTRACTOR["maxdoclen"] // 20)
    assert zoo_case(zoo_corpus, ("DeepTileBar", {})).model.ffw1.in_features == 4 * 2 * 3


def test_hint_modes(zoo_corpus):
    assert isinstance(zoo_case(zoo_corpus, ("HINT", {})).model, seq.HINTSpatialModel)
    assert isinstance(zoo_case(zoo_corpus, ("HINT", {"mode": "windowed"})).model, seq.HINTModel)
    with pytest.raises(ConfigError, match="spatial"):
        Reranker.create("HINT", {"mode": "diagonal?", "extractor": {"index": {"collection": {"name": "dummy"}}}})


def _spatial_pair(n, qlen, dlen, cdim, h, seed):
    s = np.random.RandomState(seed).randn(n, qlen, dlen, cdim).astype(np.float32)
    mod = jax_seq.SpatialGRU2D(hidden=h)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(s))
    port = seq.SpatialGRU2D(cdim, h)
    port.load_state_dict(flax_state_dict(port, {f"params/{k}": np.asarray(v) for k, v in params["params"].items()}))
    return s, mod, params, port


@pytest.mark.parametrize("shape", [(3, 5, 7, 3, 2), (2, 4, 100, 3, 2), (2, 1, 6, 3, 3), (1, 6, 2, 2, 4)])
def test_spatial_gru_matches_jax_and_the_numpy_referee(shape):
    """The anti-diagonal loop against the JAX module (1e-5) and against the
    naive double loop of ``tests/test_sequence_models.py:55`` in f64 (its
    tolerance, 2e-4 / 2e-5), at Q = 4 over a 100-token window too (103 diagonals)."""
    n, qlen, dlen, cdim, h = shape
    s, mod, params, port = _spatial_pair(n, qlen, dlen, cdim, h, seed=sum(shape))
    want = np.asarray(mod.apply(params, jnp.asarray(s)))
    with torch.no_grad():
        got = port(torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    p = {k: np.asarray(v, np.float64) for k, v in params["params"].items()}

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    def cell(x, hdiag, htop, hleft):
        rz = np.concatenate([htop, hleft, hdiag, x]) @ p["Wrz_kernel"] + p["Wrz_bias"]
        rl, rt, rd, zi, zl, zt, zd = np.split(rz, 7)
        zs = np.stack([zi, zl, zt, zd])
        zs = np.exp(zs - zs.max(axis=0)) / np.exp(zs - zs.max(axis=0)).sum(axis=0)
        r = sigmoid(np.concatenate([rl, rt, rd]))
        h1 = np.tanh(x @ p["W_kernel"] + p["W_bias"] + (r * np.concatenate([htop, hleft, hdiag])) @ p["U_kernel"]
                     + p["U_bias"])
        return zs[1] * hleft + zs[2] * htop + zs[3] * hdiag + zs[0] * h1

    for bi in range(n):
        grid = np.zeros((qlen + 1, dlen + 1, h))
        for i in range(qlen):
            for j in range(dlen):
                grid[i + 1, j + 1] = cell(s[bi, i, j].astype(np.float64), grid[i, j], grid[i, j + 1], grid[i + 1, j])
        np.testing.assert_allclose(got[bi], grid[qlen, dlen], rtol=2e-4, atol=2e-5)


def test_spatial_gru_init_is_flax_uniform():
    """Every raw leaf uniform in +-1/sqrt(hidden), as the JAX module draws them."""
    port = init_flax_(seq.SpatialGRU2D(3, 4), torch.Generator().manual_seed(0))
    values = torch.cat([p.detach().reshape(-1) for p in port.parameters()])
    assert values.abs().max() <= 0.5 and abs(float(values.std()) - 0.5 / 3 ** 0.5) < 0.03


def test_bigru_directions_position_aligned():
    """The port of ``test_bigru_directions_position_aligned``
    (``tests/test_sequence_models.py:194``): the backward half at position t
    equals a forward scan over the flipped sequence, flipped back; and the
    whole BiGRU equals the JAX ``_BiGRU``."""
    x = np.random.RandomState(3).randn(2, 6, 4).astype(np.float32)
    mod = jax_seq._BiGRU(features=3)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    port = seq._BiGRU(4, 3)
    port.load_state_dict(flax_state_dict(port, {f"params/{k}": v for k, v in flax_flat(params).items()}))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
        bwd_only = seq.run_rnn((port.GRUCell_1,), torch.from_numpy(x[:, ::-1].copy())).numpy()[:, ::-1]
    assert got.shape == (2, 6, 6)
    np.testing.assert_allclose(got, want, rtol=RECURRENT_TOL, atol=RECURRENT_TOL)
    np.testing.assert_allclose(got[..., 3:], bwd_only, rtol=RECURRENT_TOL, atol=RECURRENT_TOL)
    manual = np.asarray(jnp.flip(fnn.RNN(fnn.GRUCell(3)).apply({"params": {"cell": params["params"]["GRUCell_1"]}},
                                                                jnp.flip(jnp.asarray(x), axis=1)), axis=1))
    np.testing.assert_allclose(got[..., 3:], manual, rtol=RECURRENT_TOL, atol=RECURRENT_TOL)


def flax_flat(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path[1:]): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_cells_match_flax(cell):
    """flax's ``GRUCell`` (biases on ir, iz, in and hn only) and
    ``OptimizedLSTMCell`` (gates i, f, g, o; biases on the hidden layers)
    under ``nn.RNN``, forward and ``reverse=True, keep_order=True``, with every
    bias nonzero."""
    x = np.random.RandomState(5).randn(3, 7, 5).astype(np.float32)
    flax_cell, port_cell = ((fnn.GRUCell(4), seq.GRUCell(5, 4)) if cell == "gru"
                            else (fnn.OptimizedLSTMCell(4), seq.OptimizedLSTMCell(5, 4)))
    rnn = fnn.RNN(flax_cell)
    params = rnn.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda v: v + 0.05 * jnp.sign(v + 1e-3), params)
    flat = {f"params/{k[len('cell/'):]}": v for k, v in flax_flat(params).items()}
    port_cell.load_state_dict(flax_state_dict(port_cell, flat))
    for reverse in (False, True):
        want = np.asarray(fnn.RNN(flax_cell, reverse=reverse, keep_order=True).apply(params, jnp.asarray(x)))
        with torch.no_grad():
            xt = torch.from_numpy(x[:, ::-1].copy() if reverse else x)
            got = seq.run_rnn((port_cell,), xt).numpy()
        np.testing.assert_allclose(got[:, ::-1] if reverse else got, want, rtol=RECURRENT_TOL, atol=RECURRENT_TOL)


def test_recurrent_init_is_orthogonal_with_zero_biases():
    cell = init_flax_(seq.GRUCell(5, 4), torch.Generator().manual_seed(2))
    for name in ("hr", "hz", "hn"):
        w = getattr(cell, name).weight.detach()
        torch.testing.assert_close(w @ w.T, torch.eye(4), rtol=1e-5, atol=1e-5)
    assert cell.hn.bias.abs().max() == 0 and getattr(cell, "in").bias.abs().max() == 0


def test_tk_attention_matches_flax():
    """flax's ``MultiHeadDotProductAttention`` at TK's geometry (E 30, 10 heads
    of 3; the query scaled by 1/sqrt(3); the key mask; f32's lowest value at
    masked logits), its DenseGeneral kernels [E, H, D] and [H, D, E] carried
    over, with one sequence every key of which is masked."""
    rng = np.random.Generator(np.random.PCG64(6))
    x = rng.standard_normal((3, 9, 30)).astype(np.float32)
    mask = rng.random((3, 9)) < 0.7
    mask[:, 0] = True
    mask[2] = False
    att = fnn.MultiHeadDotProductAttention(num_heads=10, qkv_features=30)
    m = jnp.broadcast_to(jnp.asarray(mask)[:, None, None, :], (3, 1, 9, 9))
    params = att.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(x), mask=m)
    params = jax.tree_util.tree_map(lambda v: v + 0.01, params)
    want = np.asarray(att.apply(params, jnp.asarray(x), jnp.asarray(x), mask=m))
    port = seq.MultiHeadDotProductAttention(30, 10, 30)
    flat = {f"params/{k}": v for k, v in flax_flat(params).items()}
    assert flat["params/query/kernel"].shape == (30, 10, 3) and flat["params/out/kernel"].shape == (10, 3, 30)
    port.load_state_dict(flax_state_dict(port, flat))
    assert set(flax_flat_params(port)) == set(flat)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_tk_positional_encoding_and_layer_norm_epsilon(zoo_corpus):
    c = zoo_case(zoo_corpus, ("TK", {"ffdim": 12}))
    assert all(m.eps == 1e-6 for m in c.model.modules() if isinstance(m, torch.nn.LayerNorm))
    for dim in (8, 7, 300):
        pe = seq.positional_encoding(800, dim)
        assert pe.dtype == np.float32 and pe.shape == (800, dim)
        np.testing.assert_allclose(pe[:, 0], np.sin(np.arange(800.0)), rtol=0, atol=1e-6)
    assert c.model.att_0.head_dim == 1  # max(heads, (E // heads) heads) = 10 at E = 8: one feature a head


def test_dropout_sites_are_seeded_per_site(zoo_corpus):
    """DUET's dropoutrate, POSITDRMM's 0.2 on its inputs and TK's 0.1 on the
    positional branch: a seed gives the same scores twice, another seed
    others, no seed the test forward."""
    for case in (("DUET", {"nhidden": 40}), ("POSITDRMM", {"hidden": 6}), ("TK", {"ffdim": 12})):
        c = zoo_case(zoo_corpus, case)
        batch = c.batches[0]
        with torch.no_grad():
            a = torch.stack(c.port_rr.score(batch, "cpu", dropout_seed=3))
            b = torch.stack(c.port_rr.score(batch, "cpu", dropout_seed=3))
            other = torch.stack(c.port_rr.score(batch, "cpu", dropout_seed=4))
            plain = torch.stack(c.port_rr.score(batch, "cpu"))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, other) and not torch.equal(a, plain), case
        np.testing.assert_allclose(plain[0].numpy(), c.port_test(batch), rtol=0, atol=0)
