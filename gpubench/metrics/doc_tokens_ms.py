"""ms a request of tokenizing candidate documents that bertpassage's passage
cache has not seen: the program's ``features.doc_tokens`` spans (one a cache
miss) inside its ``rerank.features`` spans, over the window's finished
requests. It falls as the cache fills over the window."""

from lib import spans as spans_lib


def read(run):
    spans = spans_lib.of(run, "rerank.features")
    if spans is None:
        return None
    return spans_lib.ms_per_item(run, spans.seconds("features.doc_tokens", within="rerank.features"))
