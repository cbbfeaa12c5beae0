"""monoBERT-MaxP training through the port's trainer step
(``TorchTrainer.train_step``): the f32 training forward of the positive and
the negative side (one 256-token passage each, dropout at the configuration's
rates from generators seeded per step), the pairwise hinge loss, the backward
and Adam at the schedule's rate.

Set-up builds the reranker's training model on the device with the seeded
weights and the trainer's optimizer, then runs the first three steps through
the same call the window makes (``step``), reading what the check compares:
each step's loss, every leaf's first gradient as Adam holds it after step 1
(its first moment over 1 - beta1), and every leaf's change after step 3.
The window then goes on training the same model. Each step's batch is made
on the host from the seed (``lib/triples.py``) and handed over as the
trainer's producer thread hands its batches, so the trainer's own sampler,
passage draw and collation are bypassed."""

from __future__ import annotations

import os

import torch

from lib import triples, weights, work
from lib.corpus import spread
from systems.maxp_rerank import load_seeded, program_name, sync, timer_parts

BETA1 = 0.9  # the first moment's decay of the trainer's Adam


class System:
    def __init__(self, config, mix, seed, device, tmpdir, scale=None):
        import capreolus_tpu_torch
        from capreolus_tpu_torch.core import constants
        from capreolus_tpu_torch.reranker import Reranker

        self.config, self.mix, self.seed, self.device = config, mix, seed, torch.device(device)
        self.model = dict(config["model"], **(scale or {}).get("model", {}))
        self.setup_parts = {}
        capreolus_tpu_torch.load_all_modules()
        constants["CACHE_BASE_PATH"] = os.path.join(tmpdir, "cache")
        t = config["trainer"]
        with timer_parts(self.setup_parts, "model"):
            self.reranker = Reranker.create("BERTMaxP", {
                "pretrained": (scale or {}).get("pretrained", config["pretrained"]), "allowrandominit": True,
                "aggregation": "max", "extractor": {"index": {"collection": {"name": "dummy"}}, **config["extractor"]},
                "trainer": dict(t)})
            self.trainer = self.reranker.trainer
            self.net = self.reranker.build_train_model().to(self.device)
        with timer_parts(self.setup_parts, "weights"):
            load_seeded(self.net, self.model, "classifier", seed, self.device)
            self.leaf_of = {program_name(name): name for name, _, _ in weights.bert_leaves(self.model, "classifier")}
            extra = {n for n, _ in self.net.named_parameters()} - set(self.leaf_of)
            if extra:
                raise ValueError(f"the program trains parameters the benchmark does not seed: {sorted(extra)[:3]}")
            self.optimizer = self.trainer.make_optimizer(self.reranker, self.net)
            self.trainer._placement = None  # one device: the trainer's own train() sets it so
            sync(self.device)
        self.batch, self.maxseqlen = t["batch"], config["extractor"]["maxseqlen"]
        self.step_i = 0
        self.inputs = {"model": self.model, "seed": seed, "readings": None}

    def step_seed(self, i):
        """Step i's dropout seed."""
        return weights.torch_seed(self.seed, f"dropout.{i}")

    def step(self):
        """One optimizer step over the next batch; returns {"loss": the step's loss tensor}."""
        i = self.step_i
        batches = triples.batch(self.config["batches"], self.seed, i, self.batch, self.maxseqlen)
        loss = self.trainer.train_step(self.reranker, self.net, self.optimizer, batches, i, self.step_seed(i))
        self.step_i += 1
        return {"loss": loss}

    def sync(self):
        sync(self.device)

    def warm(self):
        """The first three steps, with the readings the check compares."""
        with timer_parts(self.setup_parts, "steps"), torch.no_grad():
            start = {n: p.detach().clone() for n, p in self.net.named_parameters()}
            losses, grad = [], {}
            for k in range(3):
                with torch.enable_grad():
                    losses.append(self.step()["loss"])
                if k == 0:
                    for n, p in self.net.named_parameters():
                        state = self.optimizer.state.get(p, {})
                        m = state.get("exp_avg")
                        grad[self.leaf_of[n]] = 0.0 if m is None else float(m.double().norm() / (1.0 - BETA1))
            change = {self.leaf_of[n]: float((p.detach().double() - start[n].double()).norm())
                      for n, p in self.net.named_parameters()}
            self.inputs["readings"] = {"loss": [float(x) for x in losses], "grad": grad, "change": change}
            del start
            sync(self.device)

    def trace_on(self):
        """Nothing to record: every step's work follows from its batch's sizes."""

    def trace_off(self):
        pass

    def ops(self, records):
        """Per finished step: the model's forward over both sides' sequences
        (every key a row's mask holds), and its backward at twice the
        forward's products."""
        spec = self.config["batches"]
        l = self.maxseqlen
        seqs = 2 * self.batch
        keys = int(2 * spread(*spec["seq_len"], self.batch).sum())
        h = self.model["hidden_size"]
        forward = work.bert_encoder_ops(self.model, seqs, l, "none", keys=keys)
        forward += [{"kind": "gemm", "m": seqs, "k": h, "n": h, "dtype": "f32", "epilogue": "none"},
                    {"kind": "gemm", "m": seqs, "k": h, "n": 1, "dtype": "f32", "epilogue": "none"}]
        per_step = forward * 3
        return [op for r in records if r["answers"] is not None for op in per_step]

    def spans(self, records):
        return []

    def items(self, record):
        """Training samples (triples) a finished step took."""
        return self.batch if record["answers"] is not None else 0

    def free(self):
        del self.optimizer, self.net, self.reranker, self.trainer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
