"""Queries whose answers reached the host in the window, over the window (the
window closes when the last request begun in it has its answer)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(run.items(r) for r in run.finished) / run.window_s
