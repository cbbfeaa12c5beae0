"""monoBERT-MaxP serving through the port's ``RerankingService``: BM25 over a
seeded Robust04-shaped corpus (the port's TPU index and scoring engine), then
BERTMaxP over bertpassage features of the top ``topn``, one query a request.

Set-up writes the corpus as TREC files under the run's temporary directory,
builds the index there, builds the service over a checkpoint of zeros (written
once to ``build/gpubench/``) and loads the seeded weights on the device. The
first warm-up request calibrates the int8 scales, as the service does on its
first request; the second runs warm."""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from lib import corpus as corpus_lib
from lib import registry, weights, work

BERT_NAMES = {"q": "query", "k": "key", "v": "value", "o": "output"}


def program_name(name):
    """A ``lib/weights.py`` leaf name -> the port's BERT scorer state_dict key."""
    parts = name.split(".")
    leaf = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}
    if parts[0] == "emb":
        if parts[1] == "ln":
            return f"bert.embeddings_ln.{leaf[parts[2]]}"
        return {"word": "bert.word_embeddings", "position": "bert.position_embeddings",
                "type": "bert.token_type_embeddings"}[parts[1]]
    if parts[0].startswith("layer"):
        i = parts[0][5:]
        if parts[1] in BERT_NAMES:
            return f"bert.layer_{i}.attention.{BERT_NAMES[parts[1]]}.{leaf[parts[2]]}"
        sub = {"attn_ln": "attention_ln", "ffn_in": "intermediate", "ffn_out": "ffn_output", "out_ln": "output_ln"}
        return f"bert.layer_{i}.{sub[parts[1]]}.{leaf[parts[2]]}"
    if parts[0] == "pooler":
        return f"bert.pooler.{leaf[parts[1]]}"
    if parts[0] == "linear":
        return "linear.weight"
    return f"classifier.{leaf[parts[1]]}"


def zeros_checkpoint(model, head, path):
    """A flat ``params/...`` npz of zeros in the layout the port's loader
    reads (the JAX trainer's names, [in, out] kernels), compressed: the seeded
    weights replace it on the device."""
    if os.path.exists(path):
        return path
    h, inter = model["hidden_size"], model["intermediate_size"]
    flat = {}

    def dense(name, n_in, n_out, bias=True):
        flat[f"{name}/kernel"] = np.zeros((n_in, n_out), np.float32)
        if bias:
            flat[f"{name}/bias"] = np.zeros(n_out, np.float32)

    def ln(name):
        flat[f"{name}/scale"], flat[f"{name}/bias"] = np.ones(h, np.float32), np.zeros(h, np.float32)

    flat["params/bert/word_embeddings"] = np.zeros((model["vocab_size"], h), np.float32)
    flat["params/bert/position_embeddings"] = np.zeros((model["max_position_embeddings"], h), np.float32)
    flat["params/bert/token_type_embeddings"] = np.zeros((model["type_vocab_size"], h), np.float32)
    ln("params/bert/embeddings_ln")
    for i in range(model["num_hidden_layers"]):
        pre = f"params/bert/layer_{i}"
        for name in ("query", "key", "value", "output"):
            dense(f"{pre}/attention/{name}", h, h)
        ln(f"{pre}/attention_ln")
        dense(f"{pre}/intermediate", h, inter)
        dense(f"{pre}/ffn_output", inter, h)
        ln(f"{pre}/output_ln")
    dense("params/bert/pooler", h, h)
    if head == "classifier":
        dense("params/classifier", h, 1)
    else:
        dense("params/linear", h, model["dim"], bias=False)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez_compressed(tmp, **flat)
    os.replace(tmp, path)
    return path


def zeros_name(model, head):
    """The zeros checkpoint's file name, keyed by the widths it holds."""
    key = hashlib.sha256(json.dumps([model, head], sort_keys=True).encode()).hexdigest()[:12]
    return f"bert_zeros_{head}_{key}.npz"


def load_seeded(module, model, head, seed, device):
    """The seeded weights (``lib/weights.py``) loaded into ``module`` (a
    state_dict in the port's names) in place, on ``device``."""
    leaves = weights.bert_leaves(model, head)
    seeded = weights.seeded_weights(leaves, seed, device)
    state = module.state_dict()
    for name, tensor in seeded.items():
        key = program_name(name)
        if key.startswith("bert.") and not any(k.startswith("bert.") for k in state):
            key = key[5:]
        if state[key].shape != tensor.shape:
            raise ValueError(f"{key}: the program holds {tuple(state[key].shape)}, the seeded leaf is {tuple(tensor.shape)}")
        state[key] = tensor
    module.load_state_dict(state)


class System:
    """One cell's system under test. ``payloads()`` yields requests (a list of
    query texts each); ``dispatch(payload)`` returns the collect of its answers."""

    def __init__(self, config, mix, seed, device, tmpdir, scale=None):
        import capreolus_tpu_torch
        from capreolus_tpu_torch.core import constants
        from capreolus_tpu_torch.index import Index
        from capreolus_tpu_torch.reranker import Reranker
        from capreolus_tpu_torch.serving import RerankingService

        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        self.model = dict(config["model"], **(scale or {}).get("model", {}))
        spec = dict(config["corpus"], **(scale or {}).get("corpus", {}))
        self.setup_parts = {}

        def timer(name):
            return timer_parts(self.setup_parts, name)

        capreolus_tpu_torch.load_all_modules()
        constants["CACHE_BASE_PATH"] = os.path.join(tmpdir, "cache")
        with timer("corpus"):
            self.topics, self.docs = corpus_lib.topics_and_docs(spec, seed)
            corpus_dir = corpus_lib.write_trec(self.docs, os.path.join(tmpdir, "corpus"))
        index_cfg = {"collection": {"name": "dummy", "path": corpus_dir}, **config["index"]}
        with timer("index"):
            index = Index.create("tpu", index_cfg)
            index.create_index()
        rr_cfg = {"pretrained": (scale or {}).get("pretrained", config["pretrained"]), "allowrandominit": True,
                  "quantize": config["quantize"],
                  "extractor": {"index": index_cfg, **config["extractor"]}}
        with timer("checkpoint"):
            ckpt = zeros_checkpoint(self.model, "classifier",
                                    str(registry.ROOT / "build" / "gpubench" / zeros_name(self.model, "classifier")))
        with timer("service"):
            reranker = Reranker.create("BERTMaxP", rr_cfg)
            self.svc = RerankingService(index, reranker, ckpt, topn=config["topn"], device=self.device)
        with timer("weights"):
            load_seeded(self.svc.reranker.model, self.model, "classifier", seed, self.device)
            sync(self.device)
        self.k = mix["k"]
        self.inputs = {"docs": self.docs, "topics": self.topics, "model": self.model, "seed": seed}
        self._hook = None

    def payloads(self):
        rng = corpus_lib.rng_of(self.seed, "requests")
        n = self.mix["queries_per_request"]
        while True:
            for i in rng.permutation(len(self.topics)):
                yield [self.topics[int(j) % len(self.topics)] for j in range(int(i), int(i) + n)]

    def warm(self):
        """Two requests of warm-up queries the window never sends: the first
        calibrates int8 and builds the kernels, the second runs warm."""
        rng = corpus_lib.rng_of(self.seed, "warm")
        self.inputs["warm"] = [f"{self.topics[int(rng.integers(len(self.topics)))]} {w}"
                               for w in ("warm", "up")]
        with timer_parts(self.setup_parts, "warm"):
            for q in self.inputs["warm"]:
                self.svc.search([q], k=self.k)
            sync(self.device)

    def dispatch(self, payload):
        collect = self.svc.search_async(payload, k=self.k)

        def answers():
            hits = collect()
            return {"hits": hits, "stages": dict(self.svc.last_stage_ms)}

        return answers

    # ---------------------------------------------------------------- tracing
    def trace_on(self):
        """Records every encoder forward's batch and needed keys (a forward
        pre-hook on the port's encoder), for the work of the traced window."""
        self.forwards = []

        def hook(module, args):
            mask = args[1]
            keys = mask.sum(dim=1)
            keys = torch.where(keys > 0, keys, mask.shape[1]).sum()
            self.forwards.append((mask.shape[0], mask.shape[1], keys))

        self._hook = self.svc.reranker.model.bert.register_forward_pre_hook(hook)

    def trace_off(self):
        if self._hook is not None:
            self._hook.remove()
            self._hook = None

    def ops(self, records=None):
        """The ops of the traced window's forwards (``lib/work.py``): the
        encoder, the pooler and the classifier of each."""
        out = []
        h = self.model["hidden_size"]
        for b, l, keys in self.forwards:
            out += work.bert_encoder_ops(self.model, b, l, self.config["quantize"], keys=int(keys))
            out += [{"kind": "gemm", "m": b, "k": h, "n": h, "dtype": "f32", "epilogue": "none"},
                    {"kind": "gemm", "m": b, "k": h, "n": 1, "dtype": "f32", "epilogue": "none"}]
        return out

    def spans(self, records):
        """Per request, the program's own host-clock stages (``last_stage_ms``)."""
        return [r["answers"]["stages"] for r in records if r["answers"]]

    def items(self, record):
        """Queries a finished request answered."""
        return len(record["answers"]["hits"]) if record["answers"] else 0

    def free(self):
        self.trace_off()
        del self.svc
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class timer_parts:
    """``with timer_parts(parts, name):`` adds the block's seconds to ``parts[name]``."""

    def __init__(self, parts, name):
        self.parts, self.name = parts, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.parts[self.name] = self.parts.get(self.name, 0.0) + time.perf_counter() - self.t0
        return False
