"""``queries_per_s`` (``metrics/queries_per_s.py``) in the reranking cells: a
metric of its own because their rate, paced by the host's features, spreads
by 2-3% from run to run where the ColBERT cells, paced by the card, spread
under 1%, so it holds a bound of its own."""

from lib import registry


def read(run):
    return registry.load_module("metrics", "queries_per_s").read(run)
