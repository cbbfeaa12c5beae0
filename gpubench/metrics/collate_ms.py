"""ms a request of collating the candidates' inputs into the reranker's
batch arrays: the program's ``features.collate`` spans inside its
``rerank.features`` spans, over the window's finished requests."""

from lib import spans as spans_lib


def read(run):
    spans = spans_lib.of(run, "rerank.features")
    if spans is None:
        return None
    return spans_lib.ms_per_item(run, spans.seconds("features.collate", within="rerank.features"))
