"""``idle_share`` (``metrics/idle_share.py``) in the reranking cells, where it moves
``queries_per_s.rerank``: their rate, paced by the host's features, spreads
several times more from run to run than the ColBERT cells', so it has an
end-to-end metric and a bound of its own, and a per-layer metric moves one
end-to-end metric."""

from lib import registry


def read(run):
    return registry.load_module("metrics", "idle_share").read(run)
