"""Training samples (triples) of every step begun in the window, over the
window (it closes when the last step begun in it has finished on the card)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(run.items(r) for r in run.finished) / run.window_s
