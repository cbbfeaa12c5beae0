"""KNRM's test MAP on the rerank golden over trainer seeds, through the JAX
package's rerank task and the port's, on the CPU (not a test: run it by hand).

    JAX_PLATFORMS=cpu python tests/torch_rerank_seed_spread.py [first_seed] [last_seed]

The config is ``tests/test_e2e_rerank_golden.py``'s KNRM leg (random8
embeddings, finetune, 4 iterations of 256 samples, lr 0.05); the seed is
``reranker.trainer.seed``, which draws the init (the samplers keep their own
seed). The JAX package runs on one CPU device here (its test suite runs on an
8-device CPU mesh, which sums its gradients in another order). Prints one JSON
line: {"jax": {seed: map}, "port": {seed: map}} and each side's mean.
"""

import copy
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import test_e2e_rerank_golden as golden  # noqa: E402
from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu_torch.core import constants as port_constants  # noqa: E402


def main(first=40, last=47):
    base = Path(tempfile.mkdtemp(prefix="rerank_seed_spread_"))
    docs, topics, qrels = golden.build_rerank_corpus()
    (base / "corpus").mkdir()
    with open(base / "corpus" / "docs.trec", "wt", encoding="utf-8") as fh:
        for docid, text in docs:
            fh.write(f"<DOC>\n<DOCNO>{docid}</DOCNO>\n<TEXT>\n{text}\n</TEXT>\n</DOC>\n")
    with open(base / "qrels.txt", "wt", encoding="utf-8") as fh:
        for qid in sorted(qrels):
            for docid, rel in sorted(qrels[qid].items()):
                fh.write(f"{qid} 0 {docid} {rel}\n")
    with open(base / "topics.tsv", "wt", encoding="utf-8") as fh:
        for qid in sorted(topics):
            fh.write(f"{qid}\t{topics[qid]}\n")
    golden._STATE.update(corpus_dir=base / "corpus", qrel_fn=base / "qrels.txt", topic_fn=base / "topics.tsv")
    jax_constants["CACHE_BASE_PATH"] = base / "jax_cache"
    port_constants["CACHE_BASE_PATH"] = base / "port_cache"
    chip_smoke.setup_rerank_golden(str(base / "port"))
    test_qids = sorted(topics)[sum(chip_smoke.RERANK_GOLDEN["split"][:2]):]
    out = {"jax": {}, "port": {}}
    for seed in range(first, last + 1):
        cfg = copy.deepcopy(chip_smoke.RERANK_GOLDEN_CONFIGS["KNRM"])
        cfg["trainer"]["seed"] = seed
        jax_constants["RESULTS_BASE_PATH"] = base / f"jax_results{seed}"
        _, _, preds = golden._run_rerank(copy.deepcopy(cfg))
        out["jax"][seed] = round(golden._metric(preds["test"], qrels)["map"], 4)
        port_constants["RESULTS_BASE_PATH"] = base / f"port_results{seed}"
        _, _, preds = chip_smoke.rerank_golden_run(cfg, "cpu")
        out["port"][seed] = round(chip_smoke.golden_map(preds["test"], qrels, test_qids), 4)
    out["mean"] = {side: round(float(np.mean(list(maps.values()))), 4) for side, maps in out.items()}
    print(json.dumps(out))


if __name__ == "__main__":
    main(*map(int, sys.argv[1:3]))
