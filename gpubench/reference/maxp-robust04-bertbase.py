"""The reference of monoBERT-MaxP training (``reference/plain.py``'s BERT with
autograd): three steps from the seeded weights over the seeded batches
(``lib/triples.py``), each the f32 training forward of the positive and the
negative side with dropout, the pairwise hinge loss, the backward and Adam
(torch's, betas 0.9 and 0.999, eps 1e-8) at the published schedule's rate.

Dropout: each site draws ``torch.rand`` of its tensor's shape from a
generator on the tensor's device, seeded as the port documents its sites
(``fold`` below, a copy of its rule): path (0,) after the embeddings, (layer
+ 1, 0) the attention probabilities, (layer + 1, 1) the attention output,
(layer + 1, 2) the FFN output, under the side's seed (the step's seed folded
with the micro-batch 0, then 1000 for the positive and 1001 for the
negative); a value is kept where the draw is at least the rate, and scaled
by 1 / (1 - rate).

The numbers compared, each the widest over its leaves or steps:
``loss_gap``, a step's |loss - reference| over the reference's; ``grad_gap``,
a leaf's |first-gradient norm - reference| over the larger of the
reference's and the median leaf's; ``change_gap``, the same for the change of
a leaf over the three steps, over the leaves whose reference gradient is at
least a thousandth of the median leaf's (a key's bias, whose gradient is nought
under softmax, moves under Adam by round-off alone).

The controls, each put in the program's place: ``tf32``, the reference with
every forward product's operands at TF32; ``half_batch``, the reference over
the first half of each batch, its loss the mean over that half."""

from __future__ import annotations

import numpy as np
import torch

from lib import registry, triples, weights

plain = registry.load_module("reference", "plain")

SEED_MASK = (1 << 63) - 1
BETAS, EPS = (0.9, 0.999), 1e-8
STEPS = 3


def fold(seed, *path):
    """The seed of a dropout site's generator: the port's rule, as its encoder documents it."""
    for p in path:
        seed = (seed * 1000003 + int(p) + 1) & SEED_MASK
    return seed


def dropout(x, rate, seed):
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def learning_rate(t, base, step):
    """The rate at optimizer step ``step`` (0 first), in f32: linear warmup over
    ``warmupiters`` iterations while ``step`` is within it, else the decay."""
    f32 = np.float32
    per_iter = max(1, ((t["itersize"] // t["batch"]) or 1) // t["gradacc"])
    warmup = t["warmupiters"] * per_iter
    s = f32(step)
    mult = f32(1.0)
    if t["decaytype"] == "linear" and t["decay"]:
        mult = f32(1.0) / (f32(1.0) + f32(t["decay"]) * (s - f32(warmup)) / f32(per_iter))
    elif t["decaytype"] == "exponential" and t["decay"]:
        mult = np.power(f32(t["decay"]), (s - f32(warmup)) / f32(t["decayiters"] * per_iter))
    if warmup and step <= warmup:
        mult = np.minimum((s + f32(1.0)) / f32(warmup), f32(1.0))
    return float(f32(base) * f32(mult))


class Trainer:
    def __init__(self, inputs, config, device, products=None, half=False):
        plain.no_tf32()
        self.config, self.device, self.half = config, torch.device(device), half
        self.model, self.seed = inputs["model"], inputs["seed"]
        self.products = products
        self.w = weights.seeded_weights(weights.bert_leaves(self.model, "classifier"), self.seed, self.device)
        for p in self.w.values():
            p.requires_grad_(True)
        t = config["trainer"]
        groups = {"bert": [k for k in self.w if not k.startswith("classifier.")],
                  "other": [k for k in self.w if k.startswith("classifier.")]}
        base = {"bert": t["bertlr"], "other": t["lr"]}
        self.opt = torch.optim.Adam([{"params": [self.w[k] for k in ks], "lr": base[g], "base_lr": base[g]}
                                     for g, ks in groups.items()], betas=BETAS, eps=EPS)

    def scores(self, ids, mask, seg, seed):
        rates = self.config["dropout"]

        def drop(x, *path):
            rate = rates["attention"] if len(path) == 2 and path[1] == 0 else rates["hidden"]
            return dropout(x, rate, fold(seed, *path))

        bert = plain.Bert(self.model, self.w, products=self.products, drop=drop)
        hid = bert.forward(ids, mask, seg)
        w, mm = self.w, bert.mm
        pooled = torch.tanh(mm(hid[:, 0]) @ mm(w["pooler.w"]).T + w["pooler.b"])
        return (mm(pooled) @ mm(w["classifier.w"]).T + w["classifier.b"])[:, 0]

    def step(self, i):
        t = self.config["trainer"]
        batch = triples.batch(self.config["batches"], self.seed, i, t["batch"], self.config["extractor"]["maxseqlen"])
        rows = t["batch"] // 2 if self.half else t["batch"]
        seed = fold(weights.torch_seed(self.seed, f"dropout.{i}"), 0)
        side = [[torch.from_numpy(batch[f"{s}_{k}"][0][:rows]).to(self.device) for k in ("bert_input", "mask", "seg")]
                for s in ("pos", "neg")]
        pos = self.scores(*side[0], fold(seed, 1000))
        neg = self.scores(*side[1], fold(seed, 1001))
        loss = torch.mean(torch.relu(1.0 - (pos - neg)))
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.opt.param_groups:
            group["lr"] = learning_rate(t, group["base_lr"], i)
        self.opt.step()
        return float(loss.detach())

    def readings(self):
        """{"loss": [3 losses], "grad": {leaf: first-gradient norm}, "change": {leaf: change after 3 steps}}."""
        start = {k: v.detach().clone() for k, v in self.w.items()}
        losses, grad = [], {}
        for i in range(STEPS):
            losses.append(self.step(i))
            if i == 0:
                grad = {k: float(self.opt.state[v]["exp_avg"].double().norm() / (1.0 - BETAS[0]))
                        for k, v in self.w.items()}
        change = {k: float((v.detach().double() - start[k].double()).norm()) for k, v in self.w.items()}
        return {"loss": losses, "grad": grad, "change": change}


def compare(got, ref):
    """The three numbers compared of ``got``'s readings against ``ref``'s."""
    if got is None:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got["loss"], ref["loss"]))
    g_med = float(np.median(list(ref["grad"].values())))
    grad_gap = max(abs(got["grad"].get(k, 0.0) - r) / max(r, g_med, 1e-30) for k, r in ref["grad"].items())
    moved = [k for k, r in ref["grad"].items() if r >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][k] for k in moved]))
    change_gap = max(abs(got["change"].get(k, 0.0) - ref["change"][k]) / max(ref["change"][k], c_med, 1e-30)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def check(inputs, config, mix, records, device):
    """The set-up's first three steps (``inputs["readings"]``) against the reference's."""
    return compare(inputs["readings"], Trainer(inputs, config, device).readings())


def control(**low_kw):
    def read(inputs, config, mix, records, device):
        low = Trainer(inputs, config, device, **low_kw).readings()
        return compare(low, Trainer(inputs, config, device).readings())

    return read


CONTROLS = {"tf32": control(products=plain.tf32_through), "half_batch": control(half=True)}
