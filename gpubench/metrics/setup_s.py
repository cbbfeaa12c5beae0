"""Seconds from the process's start to the first timed request: the
interpreter and imports, the data made from the seed, index, weights, upload,
any kernel build, and the warm-up requests (``Run.setup_parts`` splits it)."""


def read(run):
    return run.setup_s
