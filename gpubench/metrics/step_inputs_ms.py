"""ms a training step of copying its batch to the device, as a traced run
sees it: the program's ``reranker.inputs`` spans (one a batch array, from
pageable host memory) inside its ``trainer.step`` spans, over the window's
steps. Untraced, such a copy waits for the card's earlier work; traced, the
profiler makes the host slower than the card, so the copies find it idle and
this holds their own host cost without that wait."""

from lib import spans as spans_lib


def read(run):
    spans = spans_lib.of(run, "trainer.step")
    if spans is None:
        return None
    return spans_lib.ms_per_item(run, spans.seconds("reranker.inputs", within="trainer.step"))
