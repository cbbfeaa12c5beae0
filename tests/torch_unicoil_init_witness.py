"""uniCOIL's tiny train-then-serve loop on the rerank golden, from one init in
both packages, on the CPU (not a test: run it by hand; the test
``test_torch_rerank_golden.py::test_unicoil_golden_outcome_from_one_init_matches_jax``
holds two of its cells).

    JAX_PLATFORMS=cpu python tests/torch_unicoil_init_witness.py [seed ...]

The config is ``chip_smoke.GOLDEN15``'s uniCOIL leg (tiny BERT, 2 iterations
of 256 samples, lr 1e-3) with dropout 0, so that nothing but the init and
float rounding separates the two trainers. For each ``reranker.trainer.seed``
it trains from the port's init of that seed and from the JAX package's
(``PRNGKey(seed)`` through flax), each init carried into the other package,
and prints one JSON line: for each seed and init, each package's test MAP
and how many of the 160 test candidates score above 0. A uniCOIL whose ReLU
token weights all reach 0 in training scores every candidate 0: its test MAP
is the tied first stage's (0.3329) and the impact searcher indexes nothing.
"""

import contextlib
import copy
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from flax import serialization  # noqa: E402

import capreolus_tpu_torch  # noqa: E402
import chip_smoke  # noqa: E402
import test_e2e_rerank_golden as golden  # noqa: E402
from capreolus_tpu.core import constants as jax_constants  # noqa: E402
from capreolus_tpu.reranker.unicoil import UniCoil as JaxUniCoil  # noqa: E402
from capreolus_tpu_torch.convert import flatten_tree  # noqa: E402
from capreolus_tpu_torch.core import constants as port_constants  # noqa: E402
from capreolus_tpu_torch.reranker import Reranker as PortReranker  # noqa: E402
from capreolus_tpu_torch.utils.flax_msgpack import from_bytes, to_bytes  # noqa: E402

capreolus_tpu_torch.load_all_modules()


def unicoil_config(seed):
    """``chip_smoke.GOLDEN15``'s uniCOIL reranker (dropout 0) at trainer ``seed``."""
    cfg = copy.deepcopy(chip_smoke.GOLDEN15["unicoil"][0])
    cfg["hidden_dropout_prob"] = 0.0
    cfg["trainer"]["seed"] = seed
    return cfg


def write_golden(base):
    """The rerank golden under ``base``, registered in both packages (the JAX
    suite's collection reads ``golden._STATE``). Returns (qrels, test qids)."""
    base = Path(base)
    docs, topics, qrels = golden.build_rerank_corpus()
    (base / "corpus").mkdir(parents=True)
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
    chip_smoke.setup_rerank_golden(str(base / "port"))
    return qrels, sorted(topics)[sum(chip_smoke.RERANK_GOLDEN["split"][:2]):]


@contextlib.contextmanager
def patched(cls, name, value):
    saved = cls.__dict__[name]
    setattr(cls, name, value)
    try:
        yield
    finally:
        setattr(cls, name, saved)


def port_init(seed):
    """The port's init of uniCOIL at trainer ``seed``, as flax msgpack bytes."""
    captured = {}
    own = PortReranker.init_params

    def recording(self, s):
        model = own(self, s)
        captured["bytes"] = to_bytes(self.trainer.saveable_params(self, model))
        return model

    rr = PortReranker.create("unicoil", unicoil_config(seed))
    with patched(PortReranker, "init_params", recording):
        rr.init_params(seed)
    return captured["bytes"]


def jax_init(base, seed):
    """The JAX package's init of uniCOIL at trainer ``seed`` (its trainer's
    ``init_params(PRNGKey(seed), batch)``), as flax msgpack bytes: recorded
    from a JAX run, whose outcome is returned beside it."""
    captured = {}
    own = JaxUniCoil.init_params

    def recording(self, rng, batch):
        params = own(self, rng, batch)
        captured["bytes"] = serialization.to_bytes(params)
        return params

    with patched(JaxUniCoil, "init_params", recording):
        preds = run_jax(base, seed, None, "own")
    return captured["bytes"], preds


def run_jax(base, seed, init, tag):
    """JAX's rerank.traineval from ``init`` (bytes; None: its own). Returns the test predictions."""
    own = JaxUniCoil.init_params

    def carried(self, rng, batch):
        return serialization.from_bytes(own(self, rng, batch), init)

    jax_constants["RESULTS_BASE_PATH"] = Path(base) / f"jax_{tag}_{seed}"
    with patched(JaxUniCoil, "init_params", carried) if init is not None else contextlib.nullcontext():
        return golden._run_rerank(unicoil_config(seed))[2]["test"]


def run_port(base, seed, init, tag):
    """The port's rerank.traineval on the CPU from ``init`` (bytes; None: its own). Returns the test predictions."""
    own = PortReranker.init_params

    def carried(self, s):
        model = own(self, s)
        model.load_state_dict(self.state_dict_from_params(flatten_tree(from_bytes(init)), model))
        return model

    port_constants["RESULTS_BASE_PATH"] = Path(base) / f"port_{tag}_{seed}"
    with patched(PortReranker, "init_params", carried) if init is not None else contextlib.nullcontext():
        return chip_smoke.rerank_golden_run(unicoil_config(seed), "cpu")[2]["test"]


def outcome(preds, qrels, test_qids):
    """(test MAP, candidates scored above 0)."""
    return (round(chip_smoke.golden_map(preds, qrels, test_qids), 4),
            sum(1 for run in preds.values() for s in run.values() if s > 0))


def main(seeds=tuple(range(42, 54))):
    base = Path(tempfile.mkdtemp(prefix="unicoil_init_witness_"))
    jax_constants["CACHE_BASE_PATH"] = base / "jax_cache"
    port_constants["CACHE_BASE_PATH"] = base / "port_cache"
    qrels, test_qids = write_golden(base / "golden")
    out = {}
    for seed in seeds:
        init = port_init(seed)
        row = {"port_init": {"port": outcome(run_port(base, seed, None, "own"), qrels, test_qids),
                             "jax": outcome(run_jax(base, seed, init, "port_init"), qrels, test_qids)}}
        init, preds = jax_init(base, seed)
        row["jax_init"] = {"jax": outcome(preds, qrels, test_qids),
                           "port": outcome(run_port(base, seed, init, "jax_init"), qrels, test_qids)}
        out[seed] = row
        print(json.dumps({seed: row}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main(tuple(map(int, sys.argv[1:])) or tuple(range(42, 54)))
