"""A stand-in for the ``ir_datasets`` package, for the bridge in both packages'
``utils/irds.py`` (``tests/test_torch_irds.py``, and phase 19 of
``chip_smoke.py``). It imports no JAX.

``make_standin(num_docs, num_queries, seed)`` returns a module object with
``load(name)`` for a docs-only parent, ``standin-corpus``, and two datasets
over its documents, ``standin-corpus/a`` and ``standin-corpus/b``, each with
its own queries and graded qrels, all drawn from a numpy seed. Its records
have ir_datasets' shapes:

- documents are namedtuples of ``doc_id``, ``title``, ``text`` and one field
  that is not a string (``wordcount``), which the bridge leaves out of the text;
- queries have ``text``, but one query of ``standin-corpus/b`` has only a
  ``title`` (and a ``description``), which the bridge reads instead;
- qrels carry a graded ``relevance`` (0, 1 or 2) and an ``iteration``.

A test installs it with ``monkeypatch.setitem(sys.modules, "ir_datasets",
make_standin())``.
"""

import types
from collections import namedtuple

import numpy as np

StandinDoc = namedtuple("StandinDoc", ["doc_id", "title", "text", "wordcount"])
StandinQuery = namedtuple("StandinQuery", ["query_id", "text"])
StandinTitleQuery = namedtuple("StandinTitleQuery", ["query_id", "title", "description"])
StandinQrel = namedtuple("StandinQrel", ["query_id", "doc_id", "relevance", "iteration"])

PARENT = "standin-corpus"
DATASETS = (f"{PARENT}/a", f"{PARENT}/b")

_CONSONANTS = list("bdfgklmnprstvz")
_VOWELS = list("aeiou")


class StandinDataset:
    """One dataset: ``docs_iter``, ``queries_iter`` and ``qrels_iter`` as ir_datasets' own."""

    def __init__(self, docs, queries=(), qrels=()):
        self._docs, self._queries, self._qrels = list(docs), list(queries), list(qrels)

    def docs_iter(self):
        return iter(self._docs)

    def queries_iter(self):
        return iter(self._queries)

    def qrels_iter(self):
        return iter(self._qrels)

    def docs_count(self):
        return len(self._docs)


def _vocabulary(rng, size):
    words = set()
    while len(words) < size:
        n = int(rng.integers(2, 4))
        words.add("".join(rng.choice(_CONSONANTS) + rng.choice(_VOWELS) for _ in range(n)))
    return sorted(words)


def make_standin(num_docs=300, num_queries=8, seed=19, vocab_size=1500):
    """The stand-in module: ``num_docs`` documents and ``num_queries`` queries
    in each of the two datasets. Each query names three topic words: two
    documents graded 2 carry all three, three graded 1 and three unjudged
    distractors carry two, and three graded 0 carry one."""
    rng = np.random.Generator(np.random.PCG64(seed))
    vocab = _vocabulary(rng, vocab_size)
    weights = 1.0 / np.arange(1, vocab_size + 1)  # Zipf-like background words
    weights /= weights.sum()
    bodies = []
    for _ in range(num_docs):
        length = int(rng.integers(20, 121))
        bodies.append(list(rng.choice(vocab, size=length, p=weights)))
    titles = [list(rng.choice(vocab, size=int(rng.integers(2, 6)), p=weights)) for _ in range(num_docs)]
    docids = [f"SD{i:05d}" for i in range(num_docs)]

    datasets = {}
    for d, name in enumerate(DATASETS):
        queries, qrels = [], []
        for i in range(num_queries):
            qid = f"{d + 1}{i + 1:02d}"
            terms = [str(t) for t in rng.choice(vocab[vocab_size // 3:], size=3, replace=False)]
            picked = rng.choice(num_docs, size=11, replace=False)
            for rank, doc in enumerate(picked):
                # judged 2, 1 and 0, then unjudged distractors that rank among them
                grade = 2 if rank < 2 else (1 if rank < 5 else (0 if rank < 8 else None))
                carried = terms if grade == 2 else (terms[:1] if grade == 0 else terms[1:])
                for term in carried:
                    pos = int(rng.integers(0, len(bodies[doc]) + 1))
                    bodies[doc].insert(pos, term)
                if grade is not None:
                    qrels.append(StandinQrel(qid, docids[doc], grade, "0"))
            if d == 1 and i == num_queries - 1:  # a query with a title only
                queries.append(StandinTitleQuery(qid, " ".join(terms), f"documents about {terms[0]}"))
            else:
                queries.append(StandinQuery(qid, " ".join(terms)))
        datasets[name] = (queries, qrels)

    docs = [StandinDoc(docid, " ".join(title), " ".join(body), len(body))
            for docid, title, body in zip(docids, titles, bodies)]
    loaded = {PARENT: StandinDataset(docs)}
    for name, (queries, qrels) in datasets.items():
        loaded[name] = StandinDataset(docs, queries, qrels)

    def load(name):
        if name not in loaded:
            raise KeyError(f"{name!r} not found in the ir_datasets stand-in")
        return loaded[name]

    module = types.ModuleType("ir_datasets")
    module.__doc__ = "A seeded stand-in for ir_datasets (tests/torch_irds_standin.py)."
    module.load = load
    module.STANDIN = True
    return module
