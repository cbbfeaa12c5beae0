"""The share of candidate documents whose passages bertpassage's passage
cache held, over the window: 100 x (1 - the program's ``features.doc_tokens``
spans, one a miss, inside its ``features.inputs`` spans, one a candidate /
the ``features.inputs`` spans)."""

from lib import spans as spans_lib


def read(run):
    spans = spans_lib.of(run, "features.inputs")
    if spans is None:
        return None
    inputs = spans.count("features.inputs")
    return 100.0 * (1.0 - spans.count("features.doc_tokens", within="features.inputs") / inputs)
