"""ms a request of the service's hit lists: the program's ``search.hits``
spans (the host loop that turns a request's fetched scores and ordinals
into (docid, score) lists) over the window's finished requests; read where
the service's ``search.score`` spans ran."""

from lib import spans as spans_lib


def read(run):
    spans = spans_lib.of(run, "search.score")
    return None if spans is None else spans_lib.ms_per_item(run, spans.seconds("search.hits"))
