"""Median per request of the program's ``last_stage_ms["features"]``: the host's
bertpassage features and collation inside the rerank stage."""

from lib.readers import span_median


def read(run):
    return span_median(run, "features")
