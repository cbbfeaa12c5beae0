"""Command line interface (the JAX package's ``run.py``):

    python -m capreolus_tpu_torch COMMAND [(with CONFIG...)] [options]

where COMMAND is ``<task>.<command>`` (e.g. ``rank.searcheval``) and CONFIG is a list
of ``key=value`` strings (``file=path`` loads additional options from a file).

``--device=cpu|cuda`` (default ``cuda``) names the device the task runs on; the
JAX CLI takes its platform from ``JAX_PLATFORMS`` instead. A CUDA run without
a card raises.
"""

from __future__ import annotations

import sys

from capreolus_tpu_torch import load_all_modules
from capreolus_tpu_torch.core import ConfigError, config_list_to_dict
from capreolus_tpu_torch.utils.loginit import get_logger, set_log_level

logger = get_logger(__name__)

HELP = """usage:
  python -m capreolus_tpu_torch COMMAND [(with CONFIG...)] [--loglevel=LEVEL] [--device=cpu|cuda]
                                [--queue] [--priority=N]
  python -m capreolus_tpu_torch worker [--device=cpu|cuda]
  python -m capreolus_tpu_torch help [COMMAND]

COMMAND is <task>.<command>, e.g.:
  rank.searcheval with benchmark.name=dummy searcher.name=BM25
  rerank.traineval with benchmark.name=dummy reranker.name=KNRM reranker.trainer.niters=2
  modules.list_modules

CONFIG strings are dotted key=value pairs; `file=PATH` loads key=value lines from PATH.
"""


def parse_task_string(s: str):
    fields = s.split(".")
    task = fields[0]
    cmd = fields[1] if len(fields) >= 2 else None
    return task, cmd


def _load_config_file(path):
    pairs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                pairs.append(line)
    return pairs


def prepare_task(fullcommand: str, config: dict, device: str = "cuda"):
    from capreolus_tpu_torch.task import Task

    task_name, command = parse_task_string(fullcommand)
    task_cls = Task.lookup(task_name)
    if command is None:
        command = task_cls.default_command
    if command not in set(task_cls.commands) | set(task_cls.help_commands):
        raise ConfigError(f"unknown command {command!r} for task {task_name}; valid: {task_cls.commands}")
    task = Task.create(task_name, config)
    task.device = device
    return task, getattr(task, command)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("help", "-h", "--help"):
        print(HELP)
        if len(argv) > 1:
            from capreolus_tpu_torch.task import Task

            load_all_modules()
            task_name, _ = parse_task_string(argv[1])
            print(Task.lookup(task_name).describe_class())
        return 0

    loglevel = None
    device = "cuda"
    queue = False
    priority = 0
    kept = []
    for a in argv:
        if a.startswith("--loglevel="):
            loglevel = a.split("=", 1)[1]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
            if device not in ("cpu", "cuda") and not device.startswith("cuda:"):
                raise ConfigError(f"--device must be cpu or cuda, got {device!r}")
        elif a in ("-q", "--queue"):
            queue = True
        elif a.startswith("--priority="):
            priority = int(a.split("=", 1)[1])
        else:
            kept.append(a)
    argv = kept
    if loglevel:
        set_log_level(loglevel)

    fullcommand = argv[0]
    config_pairs = argv[1:]
    if config_pairs and config_pairs[0] == "with":
        config_pairs = config_pairs[1:]

    expanded = []
    for pair in config_pairs:
        if pair.startswith("file="):
            expanded.extend(_load_config_file(pair.split("=", 1)[1]))
        else:
            expanded.append(pair)

    config = config_list_to_dict(expanded)

    if queue:
        # enqueue instead of running
        from capreolus_tpu_torch.core.queue import DBManager

        DBManager().queue_run(fullcommand, config, priority)
        return 0

    if fullcommand == "worker":
        return _run_worker(device)

    load_all_modules()
    task, command_fn = prepare_task(fullcommand, config, device)
    logger.info("running %s with config %s", fullcommand, config)
    command_fn()
    return 0


def _run_worker(device="cuda"):
    """Process queued runs until the queue is empty, on ``device``."""
    from capreolus_tpu_torch.core.queue import DBManager

    load_all_modules()
    db = DBManager()
    while True:
        item = db.claim_next()
        if item is None:
            logger.info("queue empty")
            return 0
        logger.info("running queued run %d: %s", item["id"], item["command"])
        try:
            task, command_fn = prepare_task(item["command"], item["config"], device)
            command_fn()
            db.mark_done(item["id"], "done")
        except Exception as e:
            logger.exception("queued run %d failed: %s", item["id"], e)
            db.mark_done(item["id"], "failed")


if __name__ == "__main__":
    sys.exit(main())
