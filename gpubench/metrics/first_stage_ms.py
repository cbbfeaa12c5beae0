"""Median per request of the program's ``last_stage_ms["first_stage"]``
(``RerankingService``: dispatch until the BM25 hits are on the host)."""

from lib.readers import span_median


def read(run):
    return span_median(run, "first_stage")
