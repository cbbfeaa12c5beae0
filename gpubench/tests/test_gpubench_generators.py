"""The benchmark's inputs are a function of the seed alone, and every seed
asks for the same amount of work."""

import numpy as np
import torch

from lib import corpus, weights

SPEC = {"docs": 50, "min_len": 20, "max_len": 60, "vocab": 500, "topics": 12, "title_words": [2, 4],
        "title_ranks": [10, 100]}


def test_corpus_is_a_function_of_the_seed():
    a, b = corpus.topics_and_docs(SPEC, 2 ** 31 + 5), corpus.topics_and_docs(SPEC, 2 ** 31 + 5)
    c = corpus.topics_and_docs(SPEC, 2 ** 31 + 6)
    assert a == b
    assert a != c
    lengths = [sorted(len(t.split()) for _, t in x[1]) for x in (a, c)]
    assert lengths[0] == lengths[1]  # the same sizes in another order
    assert sorted(len(t.split()) for t in a[0]) == sorted(len(t.split()) for t in c[0])


def test_every_title_word_is_in_the_vocabulary_ranks():
    topics, docs = corpus.topics_and_docs(SPEC, 7)
    vocab = corpus.vocabulary(corpus.rng_of(7, "corpus"), SPEC["vocab"])
    allowed = set(vocab[SPEC["title_ranks"][0]:SPEC["title_ranks"][1]])
    assert all(w in allowed for t in topics for w in t.split())


def test_query_pool_and_its_orders_are_functions_of_the_seed():
    spec = {"vocab": 300, "words": [3, 10], "pool": 40}
    pool = corpus.query_pool(spec, 11)
    assert pool == corpus.query_pool(spec, 11) != corpus.query_pool(spec, 12)
    assert sorted(len(q.split()) for q in pool) == sorted(len(q.split()) for q in corpus.query_pool(spec, 12))
    a = corpus.cycle(pool, 11, "requests")
    b = corpus.cycle(pool, 11, "requests")
    first = [next(a) for _ in range(100)]
    assert first == [next(b) for _ in range(100)]
    assert sorted(first[:40]) == sorted(pool)  # each pass is a permutation of the pool


def test_seeded_weights_are_a_function_of_the_seed():
    model = {"vocab_size": 50, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
             "intermediate_size": 16, "max_position_embeddings": 12, "type_vocab_size": 2}
    leaves = weights.bert_leaves(model, "classifier")
    a, b = weights.seeded_weights(leaves, 3, "cpu"), weights.seeded_weights(leaves, 3, "cpu")
    c = weights.seeded_weights(leaves, 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer0.q.w"], c["layer0.q.w"])
    assert torch.equal(a["layer0.attn_ln.scale"], torch.ones(8)) and torch.equal(a["layer0.q.b"], torch.zeros(8))
    assert abs(float(a["emb.word"].std()) - 0.02) < 0.005


def test_token_corpus_is_a_function_of_the_seed_read_either_way():
    from lib.tokens import TokenCorpus

    spec = {"docs": 30, "centres": 8, "noise": 1.0, "block": 7, "len": {"median": 6, "sigma": 0.5, "min": 2, "max": 14}}
    a, b, c = (TokenCorpus(spec, 16, 14, s, "cpu") for s in (2 ** 31 + 5, 2 ** 31 + 5, 2 ** 31 + 6))
    e1, e2, e3 = np.asarray(a), np.asarray(b), np.asarray(c)
    assert e1.shape == (30, 14, 16) and e1.dtype == np.float16
    assert np.array_equal(e1, e2) and not np.array_equal(e1, e3)
    assert sorted(a.lengths) == sorted(c.lengths) and a.valid_tokens == int(a.mask.sum())
    # token-major slices, as the searcher's upload reads them, and doc ranges across blocks
    assert np.array_equal(a[:, 3:5], e1[:, 3:5]) and np.array_equal(a[5:23], e1[5:23])
    assert np.array_equal(a.block(4, 2).numpy(), e1[14:21, 4])
    norms = np.linalg.norm(e1.astype(np.float32), axis=-1)
    assert np.allclose(norms[a.mask > 0], 1.0, atol=2e-3) and np.all(norms[a.mask == 0] == 0)


def test_length_quantiles_match_their_spread():
    from lib.tokens import length_quantiles

    lengths = length_quantiles({"median": 66, "sigma": 0.45, "min": 8, "max": 180}, 100001)
    assert np.all(np.diff(lengths) >= 0) and lengths.min() >= 8 and lengths.max() == 180
    assert lengths[50000] == 66 and 72 < lengths.mean() < 73.5
