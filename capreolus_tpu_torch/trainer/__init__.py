"""Trainer support. Slice 1 ports batch collation only (``collate.py``); the
trainer itself, with its checkpoint format, comes in a later slice."""
