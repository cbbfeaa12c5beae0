"""Experiment queue: enqueue runs into a sqlite DB for batch workers (a copy of
the JAX package's ``core/queue.py``).

``python -m capreolus_tpu_torch ... --queue`` inserts the command and its
config with a priority instead of running it; ``worker`` pops entries by
priority. The DB path comes from the CAPREOLUS_DB environment variable.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time
from pathlib import Path

from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS queued_runs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    command TEXT NOT NULL,
    config TEXT NOT NULL,
    priority INTEGER NOT NULL DEFAULT 0,
    status TEXT NOT NULL DEFAULT 'queued',
    created REAL NOT NULL,
    started REAL,
    finished REAL
);
"""


class DBManager:
    def __init__(self, db_path=None):
        db_path = db_path or os.environ.get("CAPREOLUS_DB", os.path.expanduser("~/.capreolus_tpu_torch/queue.sqlite"))
        Path(db_path).parent.mkdir(parents=True, exist_ok=True)
        self.conn = sqlite3.connect(db_path, timeout=30)
        self.conn.execute(_SCHEMA)
        self.conn.commit()

    def queue_run(self, command: str, config: dict, priority: int = 0) -> int:
        cur = self.conn.execute(
            "INSERT INTO queued_runs (command, config, priority, created) VALUES (?, ?, ?, ?)",
            (command, json.dumps(config), priority, time.time()),
        )
        self.conn.commit()
        logger.info("queued run %d: %s (priority %d)", cur.lastrowid, command, priority)
        return cur.lastrowid

    def claim_next(self):
        """Pop the highest-priority queued run (None if empty)."""
        with self.conn:
            row = self.conn.execute(
                "SELECT id, command, config FROM queued_runs WHERE status='queued' "
                "ORDER BY priority DESC, id ASC LIMIT 1"
            ).fetchone()
            if row is None:
                return None
            run_id, command, config = row
            self.conn.execute(
                "UPDATE queued_runs SET status='running', started=? WHERE id=?", (time.time(), run_id)
            )
        return {"id": run_id, "command": command, "config": json.loads(config)}

    def mark_done(self, run_id: int, status: str = "done"):
        with self.conn:
            self.conn.execute(
                "UPDATE queued_runs SET status=?, finished=? WHERE id=?", (status, time.time(), run_id)
            )

    def list_runs(self, status=None):
        q = "SELECT id, command, priority, status FROM queued_runs"
        args = ()
        if status:
            q += " WHERE status=?"
            args = (status,)
        return self.conn.execute(q + " ORDER BY id", args).fetchall()
