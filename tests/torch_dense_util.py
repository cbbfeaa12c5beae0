"""Shared fixtures of the dense / impact / serving parity tests: a small TREC
corpus with duplicate documents (exact score ties), its topics, and the JAX
searchers' random-init weights saved as the port's checkpoint files, so that
both packages search with the same weights (``pretrained="tiny"`` draws
flax's init in JAX and torch's in the port)."""

import jax
import numpy as np

from capreolus_tpu_torch.convert import save_params
from test_torch_bert import OFFLINE_TOKENIZER
from test_torch_index import write_trec_corpus

NUM_DOCS, NUM_DUPLICATES = 120, 6
TOPICS = {"501": "galaxy telescope orbit", "502": "whale ocean", "503": "gravity computes computation",
          "504": "launch launched hopeful", "505": "the relational conditional", "506": "w3 w7 w11",
          "507": "orbiting whales", "508": "zebra cafe naive"}


def write_dense_corpus(directory):
    """``NUM_DOCS`` seeded docs plus ``NUM_DUPLICATES`` copies (DUP0...) of the
    first docs' text: equal embeddings, so exact ties. Returns the collection config."""
    docs = write_trec_corpus(directory, num_docs=NUM_DOCS, seed=21, min_len=8, max_len=40)
    with open(directory / "part_dup.trec", "wt", encoding="utf-8") as fh:
        for i, (_, text) in enumerate(docs[:NUM_DUPLICATES]):
            fh.write(f"<DOC>\n<DOCNO> DUP{i} </DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n")
    return {"name": "dummy", "path": str(directory)}


def write_topics(path):
    path.write_text("".join(f"{qid}\t{text}\n" for qid, text in TOPICS.items()))
    return path


def searcher_config(collection, **options):
    return {"pretrained": "tiny", "maxdoclen": 32, "maxqlen": 8, "batch": 16, "tokenizer": OFFLINE_TOKENIZER,
            "index": {"collection": collection}, **options}


def flatten(tree, prefix):
    return {f"{prefix}/" + "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_dense_checkpoint(jax_searcher, path):
    """The JAX dense searcher's encoder weights as a port checkpoint (``params/bert/...``)."""
    _, variables, _ = jax_searcher._encoder()
    return str(save_params(flatten(variables["params"], "params/bert"), path))


def jax_impact_checkpoint(jax_searcher, path):
    """The JAX impact searcher's encoder and head as a port checkpoint
    (``params/bert/...`` and ``params/tokweight/...`` or ``params/mlm/...``)."""
    variables, _ = jax_searcher._encoder()
    head = "mlm" if jax_searcher.config["encoder"] == "splade" else "tokweight"
    flat = flatten(variables["encoder"]["params"], "params/bert")
    flat.update(flatten(variables["head"]["params"], f"params/{head}"))
    return str(save_params(flat, path))


def load_run(out_dir):
    from capreolus_tpu_torch.utils.trec import load_trec_run

    return load_trec_run(next(p for p in out_dir.iterdir() if p.name != "done"))


def ranked(run_for_query):
    """{docid: score} -> [(docid, score)] in rank order (descending score; the
    run file's order)."""
    return list(run_for_query.items())
