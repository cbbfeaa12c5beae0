"""Searchers. Slice 1 ports the scoring engine (``scoring.py``); the searcher
modules of the JAX package (BM25, RM3, ...) come with the rank task."""
