"""ms a request of building the candidates' BERT inputs (bertpassage's
``id2vec``: ids, masks and segments of every passage, paid on every
request): the self time of the program's ``features.inputs`` spans (one a
candidate), less the cache misses' ``features.doc_tokens`` inside them, over
the window's finished requests; read where ``rerank.features`` spans ran."""

from lib import spans as spans_lib


def read(run):
    spans = spans_lib.of(run, "rerank.features")
    if spans is None:
        return None
    return spans_lib.ms_per_item(run, spans.self_seconds("features.inputs", ["features.doc_tokens"]))
