"""The reference of ColBERT retrieval over an int8 corpus
(``reference/colbert-msmarco-bertbase.py`` at ``levels`` 127): the f32 query
encoder, then MaxSim with int8 codes, the configuration's precision: each
query's embeddings coded per query and each doc's f16 embeddings per doc
(amax / 127, round half to even), exact integer products, dequantized by the
two scales, the max over valid tokens and the sum over query tokens.

The controls, each put in the program's place for the same queries:
``int4``, the same MaxSim in int4 (amax / 7); ``tf32``, the query
encoder's f32 products at TF32."""

from __future__ import annotations

from lib import registry

plain = registry.load_module("reference", "plain")
bf16_ref = registry.load_module("reference", "colbert-msmarco-bertbase")

LEVELS = 127


def check(inputs, config, mix, records, device):
    texts, served = bf16_ref.sampled(records)
    return bf16_ref.compare(bf16_ref.Reference(inputs, config, device, levels=LEVELS), texts, served, mix["k"])


CONTROLS = {"int4": bf16_ref.control(levels=LEVELS, served_levels=7),
            "tf32": bf16_ref.control(levels=LEVELS, products=plain.tf32, served_levels=LEVELS)}
