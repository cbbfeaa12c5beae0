"""The 95th percentile of every request of the window, each timed on the host
from its dispatch to its answer on the host; a failed request counts as
infinitely late. numpy's linear interpolation between order statistics."""

import numpy as np


def read(run):
    if not run.records:
        return None
    ok = {id(r) for r in run.finished}
    ms = [(r["done"] - r["dispatch"]) * 1e3 if id(r) in ok else float("inf") for r in run.records]
    return float(np.percentile(ms, 95))
