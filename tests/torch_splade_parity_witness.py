"""SPLADE's step-1 gradient from one init, on the card, on the CPU in f32 and
on the CPU in float64 (not a test: run it on a machine with a CUDA device).

    python3 tests/torch_splade_parity_witness.py [samples ...]   # default: 1 2

``chip_smoke.py`` phase 15e holds SPLADE's step 1, card against CPU, on the
first two samples of its batch, within 1e-4 of each gradient tensor's
largest entry. This script rebuilds that batch: phase 4's seeded corpus, the
BM25 top 8 of its first topic, phase 15's seeded BERT-base masked-LM
checkpoint, SPLADE with its regularizer and dropout 0. For each sample count
it prints one JSON line with three parts:

- each f32 gradient's largest error against the float64 step, per tensor
  (the worst five), as a share of the float64 gradient's largest entry;
- the rows of ``bert.position_embeddings`` where the card and the CPU
  differ most;
- per text (query, posdoc, negdoc), the vocabulary terms whose max over
  positions (SPLADE's pooling) the card, the CPU and float64 take at
  different positions, and those positions.

If the rows where the card and the CPU differ are the positions where the
max of a near-tied term moved, then the max routed that term's gradient to
another position on each device.
"""

import contextlib
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

TEXTS = ("query", "posdoc", "negdoc")
POSITIONS = "bert.position_embeddings"


def splade_batch(workdir):
    """Phase 15e's SPLADE reranker and its batch of TRAIN15["batch"] samples."""
    import capreolus_tpu_torch
    from capreolus_tpu_torch.reranker import Reranker
    from capreolus_tpu_torch.reranker.bert import get_bert_config
    from capreolus_tpu_torch.serving import RetrievalService
    from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate

    capreolus_tpu_torch.load_all_modules()
    docs, topics, _ = cs.build_corpus(cs.SERVING_DOCS, num_topics=25, seed=20260819, min_len=200, max_len=1200)
    corpus_dir = os.path.join(workdir, "corpus")
    cs.write_trec(docs, corpus_dir)
    ckpt_dir = os.path.join(workdir, "bert_mlm_15")
    cs.write_birch_checkpoint(ckpt_dir, get_bert_config("bert-base-uncased"), seed=15, head="mlm")
    b = cs.TRAIN15["batch"]
    docids = [d for d, _ in RetrievalService.from_config(collection="dummy", collection_path=corpus_dir,
                                                         device="cuda").search(topics[:1], k=2 * b)[0]]
    cfg = json.loads(json.dumps({"pretrained": ckpt_dir, "hidden_dropout_prob": 0.0, **cs.TRAIN15_MODELS["splade"]}))
    cfg["extractor"] = {"maxqlen": cs.TRAIN15["maxqlen"], "maxdoclen": cs.TRAIN15["maxdoclen"],
                        "index": {"collection": {"name": "dummy", "path": corpus_dir}}}
    cfg.setdefault("trainer", {})["batch"] = b
    rr = Reranker.create("splade", cfg)
    rr.extractor.preprocess(["q15"], docids, {"q15": topics[0]})
    samples = [rr.extractor.id2vec("q15", docids[i], docids[b + i], label=[1, 0]) for i in range(b)]
    return rr, {k: v[None] for k, v in collate(samples, ARRAY_KEYS).items()}


@contextlib.contextmanager
def wide_floats(dtype):
    """Under float64, ``Tensor.float()`` (the encoder's casts to f32 after
    its embeddings and before its heads) leaves float64 tensors as they are,
    so that the whole step runs in float64."""
    if dtype != torch.float64:
        yield
        return
    narrow = torch.Tensor.float
    torch.Tensor.float = lambda self, *args, **kwargs: (self if self.dtype == torch.float64
                                                        else narrow(self, *args, **kwargs))
    try:
        yield
    finally:
        torch.Tensor.float = narrow


def step(rr, model, micro, device, dtype):
    """Step 1's loss and gradients (on the CPU) and, per text, the position of
    each term's max over positions ([B, V]) and that max ([B, V])."""
    with wide_floats(dtype):
        return _step(rr, model, micro, device, dtype)


def _step(rr, model, micro, device, dtype):
    from capreolus_tpu_torch.reranker.biencoder import encoder_inputs
    from capreolus_tpu_torch.reranker.common import cudnn_f32

    model.to(device=device, dtype=dtype)
    model.zero_grad(set_to_none=True)
    wide = {k: (np.asarray(v, np.float64) if dtype == torch.float64 and np.asarray(v).dtype.kind == "f" else v)
            for k, v in micro.items()}
    seed = rr.trainer.step_seed(0, 0)  # a training forward (attention_plain), as step 1's; dropout 0 draws nothing
    with cudnn_f32():
        loss = rr.trainer.compute_loss(rr, wide, torch.device(device), dropout_seed=seed)
        loss.backward()
    grads = {n: p.grad.detach().to("cpu", torch.float64) for n, p in model.named_parameters() if p.grad is not None}
    tops = {}
    with torch.no_grad():
        for key in TEXTS:
            toks, mask = encoder_inputs(torch.from_numpy(np.asarray(micro[key])).to(device), model.config.max_position)
            hidden, _ = model.bert(toks, mask, torch.zeros_like(toks), dropout_seed=seed)
            w = torch.log1p(torch.relu(model.mlm(hidden.float())))
            valid = (toks != 0) & (toks != model.cls_id) & (toks != model.sep_id)
            best, where = torch.where(valid[..., None], w, 0.0).max(dim=1)
            tops[key] = (where.cpu(), best.to("cpu", torch.float64))
    model.to(device="cpu", dtype=torch.float32)
    return float(loss.detach()), grads, tops


def moved(a, b, ref_best):
    """The (sample, term, position a, position b, max) where two devices'
    maxima sit at different positions, for terms whose max is above 0."""
    where_a, where_b = a[0], b[0]
    idx = torch.nonzero((where_a != where_b) & (ref_best > 0))
    return [(int(s), int(v), int(where_a[s, v]), int(where_b[s, v]), float(ref_best[s, v])) for s, v in idx]


def witness(rr, batch, samples):
    micro = {k: v[0, :samples] for k, v in batch.items()}
    model = rr.init_params(rr.trainer.config["seed"])
    rr.trainer.make_optimizer(rr, model)
    runs = {"card": step(rr, model, micro, "cuda", torch.float32),
            "cpu": step(rr, model, micro, "cpu", torch.float32),
            "f64": step(rr, model, micro, "cpu", torch.float64)}
    ref = runs["f64"][1]
    # as chip_smoke's step_parity: each tensor's largest entry, floored at GRAD_NOISE_FLOOR of the model's
    floor = cs.GRAD_NOISE_FLOOR * max(float(g.abs().max()) for g in ref.values())
    scale = {n: max(float(g.abs().max()), floor) for n, g in ref.items()}
    out = {"samples": samples, "loss": {k: r[0] for k, r in runs.items()}, "largest_errors": {},
           "position_rows": {}, "moved_maxima": {}}
    for a, b in (("card", "f64"), ("cpu", "f64"), ("card", "cpu")):
        pair = f"{a}_vs_{b}"
        err = {n: float((runs[a][1][n] - runs[b][1][n]).abs().max()) / scale[n] for n in ref}
        out["largest_errors"][pair] = dict(sorted(err.items(), key=lambda kv: -kv[1])[:5])
        moved_at = set()
        for key in TEXTS:
            hits = moved(runs[a][2][key], runs[b][2][key], runs["f64"][2][key][1])
            out["moved_maxima"].setdefault(key, {})[pair] = {"count": len(hits), "first": hits[:8]}
            moved_at.update(p for _, _, pa, pb, _ in hits for p in (pa, pb))
        rows = (runs[a][1][POSITIONS] - runs[b][1][POSITIONS]).abs().amax(dim=1) / scale[POSITIONS]
        out["position_rows"][pair] = [{"row": int(r), "err": float(rows[r]), "a_max_moved_there": int(r) in moved_at}
                                      for r in torch.argsort(rows, descending=True)[:6]]
    return out


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("this witness needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workdir = tempfile.mkdtemp(prefix="splade_witness_")
    os.environ["CAPREOLUS_CACHE"] = os.path.join(workdir, "cache")
    os.environ["CAPREOLUS_RESULTS"] = os.path.join(workdir, "results")
    os.environ["CAPREOLUS_OFFLINE"] = "1"
    rr, batch = splade_batch(workdir)
    for samples in [int(a) for a in argv] or [1, 2]:
        print(json.dumps(witness(rr, batch, samples)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
