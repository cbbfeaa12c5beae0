"""The trainer (the JAX package's ``trainer/jax_trainer.py``): one training
loop for every reranker, registered as ``jax``, ``pytorch`` and
``tensorflow`` with the JAX trainer's options, so its configs and results
paths carry over.

- Optimizer: ``torch.optim.Adam`` with two parameter groups, ``other`` at
  ``lr`` and ``bert`` (every path with "bert" or "electra") at ``bertlr``;
  frozen parameters (``reranker.trainable`` False) are outside the optimizer,
  keep no state, take no gradient and are left out of checkpoints. Each group's
  learning rate is set by hand before each step from ``schedule``, a copy of the
  JAX schedule in f32, at optax's step count (0 at the first update). optax's
  ``adam`` and torch's apply the same update, ``m̂ / (√v̂ + ε)``, ε = 1e-8.
- Train step: ``gradacc`` micro-batches, their gradients summed and divided by
  ``gradacc``, their mean loss reported, as the JAX step does.
- Train loop: a producer thread collates the sample stream (the samples drawn
  to initialise the model are the first batch's, as in JAX); validation every
  ``validatefreq`` iterations, ``dev.best`` on the optimized metric, the loss
  and metric files, TensorBoard events, ``negrefresh`` (ANCE-style hard
  negatives), ``fastforward`` from per-iteration checkpoints, ``profile`` (one
  ``torch.profiler`` trace of the first iteration) and ``evalbatch``.
- Dropout: a training forward of a reranker with ``accepts_rngs`` gets a seed
  deterministic in (seed + 0x5eed, iteration, step, micro-batch), so
  fastforward replays the same masks; the masks differ from JAX's.
- Checkpoints: ``<path>.params`` in flax's msgpack bytes of the JAX parameter
  tree (``utils/flax_msgpack.py``), frozen leaves written empty and keys in
  the order the JAX trainer writes them, so a
  ``dev.best`` of either trainer loads in the other package;
  ``<path>.optstate`` is the torch optimizer's state, read only by this
  trainer's fastforward; ``<path>.done`` marks a complete checkpoint.

The trainer runs on ``self.device`` (an attribute, not a config option, so it
never enters the results path; ``None`` means "cuda"), which the rerank task
sets. Options that select code the port does not have raise ``ConfigError``
naming their ROADMAP.md item: ``tp``, ``pp``, ``ep``, ``sp``, ``fsdp`` and a
``ckpt`` other than ``flat`` (item 6, "Multi-device"), ``amp`` other than
``none`` (item 6, "the amp slice") and ``loss=infonce`` (item 6, dense
retrieval).
"""

from __future__ import annotations

import collections
import itertools
import queue as _queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from capreolus_tpu_torch.core import ConfigError, ConfigOption, constants
from capreolus_tpu_torch.evaluation import eval_runs
from capreolus_tpu_torch.reranker.common import LOSS_FUNCTIONS
from capreolus_tpu_torch.trainer import Trainer
from capreolus_tpu_torch.trainer.collate import ARRAY_KEYS, collate
from capreolus_tpu_torch.utils.loginit import get_logger

logger = get_logger(__name__)

# batches whose scores may wait on the device before the host copies the oldest
PREDICT_PIPELINE_DEPTH = 8
DROPOUT_SEED_OFFSET = 0x5EED


def select_hard_negatives(preds, depth):
    """{qid: {docid: score}} -> {qid: [depth hardest docids]}, score-descending
    with docid tie-break (deterministic refresh given deterministic scores)."""
    return {qid: [d for d, _ in sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:depth]]
            for qid, scores in preds.items()}


def _ext(path, suffix):
    """Append a suffix without clobbering existing dots in the name (dev.best)."""
    path = Path(path)
    return path.parent / (path.name + suffix)


def schedule(base_lr, step, warmup_steps, decaytype, decay, decay_steps, per_iter):
    """The JAX trainer's learning rate at optimizer step ``step`` (0 at the
    first update), computed in f32 as it is: warmup ``min((step + 1) /
    warmup, 1)`` while ``step <= warmup_steps``, then exponential or linear decay."""
    f32 = np.float32
    step = f32(step)
    mult = f32(1.0)
    if decaytype == "exponential" and decay:
        mult = np.power(f32(decay), (step - f32(warmup_steps)) / f32(decay_steps))
    elif decaytype == "linear" and decay:
        mult = f32(1.0) / (f32(1.0) + f32(decay) * (step - f32(warmup_steps)) / f32(per_iter))
    if warmup_steps:
        warm = np.minimum((step + f32(1.0)) / f32(warmup_steps), f32(1.0))
        mult = warm if step <= warmup_steps else mult
    return f32(base_lr) * f32(mult)


def _unported(what, item):
    return ConfigError(f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")


@Trainer.register
class TorchTrainer(Trainer):
    module_name = "jax"
    config_spec = [
        ConfigOption("batch", 32, "batch size"),
        ConfigOption("niters", 20, "number of iterations to train for"),
        ConfigOption("itersize", 512, "number of training samples per iteration"),
        ConfigOption("gradacc", 1, "number of gradient accumulation steps"),
        ConfigOption("lr", 0.001, "learning rate"),
        ConfigOption("bertlr", 0.00002, "learning rate for bert/electra parameters"),
        ConfigOption("loss", "pairwise_hinge_loss", "pairwise_hinge_loss, pair_softmax_loss, "
                     "crossentropy, lce, margin_mse (teacher-margin distillation; needs "
                     "sampler.name=distill), or infonce (in-batch negatives with cross-device "
                     "negative sharing; needs a reranker exposing encode, e.g. biencoder)"),
        ConfigOption("softmaxloss", False, "use softmax loss instead of hinge"),
        ConfigOption("fastforward", False, "resume from per-iteration checkpoints"),
        ConfigOption("ckpt", "flat", "checkpoint format: flat (single-file flax bytes, gathers "
                     "to one host), sharded (per-shard raw .npy — each process writes only its "
                     "addressable shards, restores across different mesh layouts), or "
                     "sharded_async (sharded + background file writes off the train loop)"),
        ConfigOption("validatefreq", 1, "validate every N iterations"),
        ConfigOption("negrefresh", 0, "ANCE-style hard-negative refresh: every N iterations, "
                     "re-score each training query's ORIGINAL candidate pool with the CURRENT "
                     "model and replace the sampler's negative pools with the top neghard "
                     "hardest (0 disables; needs a sampler whose stream reads live pools — "
                     "triplet/pair/LCE, not distill)"),
        ConfigOption("neghard", 200, "negrefresh pool depth: keep this many hardest "
                     "(highest-scoring non-relevant) candidates per query"),
        ConfigOption("warmupiters", 0, "linear warmup iterations"),
        ConfigOption("decay", 0.0, "decay factor"),
        ConfigOption("decaytype", None, "decay type: exponential, linear, or None"),
        ConfigOption("decayiters", 3, "iterations over which exponential decay spreads"),
        ConfigOption("amp", "none", "bfloat16 mixed precision: none/False, train, pred, both, or True "
                     "(string values match the reference pytorch trainer, pytorch.py:43)", value_type="str"),
        ConfigOption("tp", 1, "tensor-parallel degree (not ported: 1 only)"),
        ConfigOption("pp", 1, "pipeline-parallel degree (not ported: 1 only)"),
        ConfigOption("ep", 1, "expert-parallel degree (not ported: 1 only)"),
        ConfigOption("sp", False, "sequence parallelism (not ported)"),
        ConfigOption("microbatches", 0, "pipeline microbatches per step (0 = auto; pipeline "
                     "parallelism is not ported)"),
        ConfigOption("fsdp", False, "fully-sharded data parallelism (not ported)"),
        ConfigOption("boardname", "default", "experiment label for artifacts"),
        ConfigOption("profile", False, "capture a torch profiler trace of the first iteration"),
        ConfigOption("evalbatch", 0, "prediction batch size (0 = use the training batch size)"),
        ConfigOption("eager", False, "accepted for JAX-config compatibility (the port runs op by op)"),
        # reference-config compatibility (trainer/tensorflow.py options): accepted, not needed
        ConfigOption("usecache", False, "accepted for reference-config compatibility"),
        ConfigOption("multithread", False, "accepted for reference-config compatibility (torch DataLoader workers)"),
        ConfigOption("storage", None, "accepted for reference-config compatibility (TF GCS staging)"),
        ConfigOption("tpuname", None, "accepted for reference-config compatibility (TF TPUClusterResolver)"),
        ConfigOption("tpuzone", None, "accepted for reference-config compatibility (TF TPUClusterResolver)"),
    ]
    config_keys_not_in_path = ["fastforward", "boardname", "validatefreq", "profile",
                               "evalbatch", "eager", "usecache", "multithread", "storage", "tpuname", "tpuzone"]
    device = None  # set by the rerank task or the caller; None means "cuda"
    PREDICT_CACHE_BYTES = 2 << 30  # materialize+cache pred features up to 2 GiB
    _TB_HISTOGRAM_PARAM_LIMIT = 1 << 22  # ~4M params

    def build(self):
        self._model = None
        self._optimizer = None

    # ------------------------------------------------------------------ setup
    def _device(self):
        from capreolus_tpu_torch.serving import resolve_device

        return resolve_device(self.device)

    def _check_unported(self):
        """Refuse the options whose code the port does not have."""
        c = self.config
        for key in ("tp", "pp", "ep"):
            if int(c.get(key, 1)) > 1:
                raise _unported(f"trainer.{key}={c[key]}", "item 6, 'Multi-device'")
        for key in ("sp", "fsdp"):
            if c.get(key):
                raise _unported(f"trainer.{key}=True", "item 6, 'Multi-device'")
        if str(c.get("ckpt", "flat")) != "flat":
            if str(c["ckpt"]) not in ("sharded", "sharded_async"):
                raise ConfigError(f"trainer.ckpt must be flat, sharded, or sharded_async (got {c['ckpt']!r})")
            raise _unported(f"trainer.ckpt={c['ckpt']} (sharded checkpoints)", "item 6, 'Multi-device'")
        raw = str(c["amp"]).lower()
        mode = {"false": "none", "none": "none", "0": "none", "": "none", "true": "both", "1": "both"}.get(raw, raw)
        if mode not in ("none", "train", "pred", "both"):
            raise ConfigError(f"amp must be one of: none, train, pred, both (got {c['amp']!r})")
        if mode != "none":
            raise _unported(f"trainer.amp={c['amp']} (bf16 mixed precision)", "item 6, 'the amp slice'")
        if c["loss"] == "infonce":
            raise _unported("trainer.loss=infonce (in-batch negatives over a biencoder's embeddings)",
                            "item 6, 'Dense and learned-sparse retrieval'")

    def _loss_fn(self):
        loss = self.config["loss"]
        if self.config["softmaxloss"]:
            # the reference flag swaps the pairwise HINGE for pair softmax; the
            # structured losses (lce/crossentropy/margin_mse) cannot take it
            if loss not in ("pairwise_hinge_loss", "pair_hinge_loss", "pair_softmax_loss"):
                raise ConfigError(
                    f"trainer.softmaxloss replaces the pairwise hinge and cannot be combined "
                    f"with trainer.loss={loss}; drop softmaxloss or set loss=pair_softmax_loss")
            return LOSS_FUNCTIONS["pair_softmax_loss"]
        if loss not in LOSS_FUNCTIONS:
            raise ConfigError(f"unknown loss {loss!r}; valid losses: {sorted(LOSS_FUNCTIONS)}")
        return LOSS_FUNCTIONS[loss]

    @property
    def steps_per_iter(self):
        """Optimizer steps per iteration (batches per iter / gradient accumulation)."""
        return max(1, self.n_batch_per_iter // self.config["gradacc"])

    def learning_rate(self, base_lr, step):
        c = self.config
        return schedule(base_lr, step, c["warmupiters"] * self.steps_per_iter, c["decaytype"], c["decay"],
                        max(1, c["decayiters"] * self.steps_per_iter), self.steps_per_iter)

    @staticmethod
    def param_labels(reranker, model):
        """{torch parameter name: "frozen" | "bert" | "other"}, from the JAX path
        of each parameter, as the JAX trainer labels its tree."""
        from capreolus_tpu_torch.convert import _flax_leaves

        params = dict(model.named_parameters())
        labels = {}
        for key, name, _ in _flax_leaves(model):
            path = tuple(key.split("/"))
            if not reranker.trainable(path, params[name]):
                labels[name] = "frozen"
            elif "bert" in key.lower() or "electra" in key.lower():
                labels[name] = "bert"
            else:
                labels[name] = "other"
        return labels

    def make_optimizer(self, reranker, model):
        """Adam over the trainable parameters in the ``other`` and ``bert``
        groups; frozen parameters stop requiring grad and stay outside."""
        labels = self.param_labels(reranker, model)
        groups = {"other": [], "bert": []}
        for name, p in model.named_parameters():
            if labels[name] == "frozen":
                p.requires_grad_(False)
            else:
                groups[labels[name]].append(p)
        base = {"other": self.config["lr"], "bert": self.config["bertlr"]}
        param_groups = [{"params": ps, "lr": float(base[g]), "base_lr": float(base[g])}
                        for g, ps in groups.items() if ps]
        if not param_groups:
            raise ConfigError(f"{reranker.module_name} has no trainable parameter")
        return torch.optim.Adam(param_groups, betas=(0.9, 0.999), eps=1e-8)

    # ------------------------------------------------------------------ train step
    def _check_loss_support(self, reranker):
        if self.config["loss"] == "lce" and not hasattr(reranker, "score_lce"):
            raise ConfigError(
                f"trainer.loss=lce needs a reranker with multi-negative scoring "
                f"(score_lce); {type(reranker).module_name} does not support it")

    def compute_loss(self, reranker, micro, device, dropout_seed=None):
        """The training loss of one micro-batch (a training forward)."""
        loss_fn = self._loss_fn()
        kwargs = {"dropout_seed": dropout_seed} if reranker.accepts_rngs else {}
        name = self.config["loss"]
        if name == "lce":
            return loss_fn(reranker.score_lce(micro, device, **kwargs), None)
        pos, neg = reranker.score(micro, device, **kwargs)
        if name == "crossentropy":
            return loss_fn(torch.stack([neg, pos], dim=1).float(), reranker.put(micro, "label", device))
        if name == "margin_mse":
            return loss_fn(pos.float().reshape(-1), neg.float().reshape(-1),
                           reranker.put(micro, "teacher_margin", device).float().reshape(-1))
        return loss_fn([pos.float(), neg.float()])

    def train_step(self, reranker, model, optimizer, batches, step, step_seed):
        """One optimizer step over ``batches`` ([gradacc, batch, ...] arrays) at
        optimizer step ``step``; returns the mean micro-batch loss (a tensor)."""
        device = next(model.parameters()).device
        gradacc = self.config["gradacc"]
        optimizer.zero_grad(set_to_none=True)
        from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

        loss_sum = torch.zeros((), device=device)
        for g in range(gradacc):
            micro = {k: v[g] for k, v in batches.items()}
            loss = self.compute_loss(reranker, micro, device, dropout_generator_seed(step_seed, g))
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        if gradacc > 1:
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.div_(gradacc)
        self.optimizer_step(optimizer, step)
        return loss_sum / gradacc

    def optimizer_step(self, optimizer, step):
        """Apply the gradients at optimizer step ``step``: each group's rate from
        the schedule, then Adam."""
        for group in optimizer.param_groups:
            group["lr"] = float(self.learning_rate(group["base_lr"], step))
        optimizer.step()

    def step_seed(self, niter, step_i):
        """The dropout seed of step ``step_i`` of iteration ``niter``."""
        from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

        return dropout_generator_seed(self.config["seed"] + DROPOUT_SEED_OFFSET, niter * self.steps_per_iter + step_i)

    # ------------------------------------------------------------------ public API
    def train(self, reranker, train_dataset, train_output_path, dev_data, dev_output_path,
              qrels, metric="map", relevance_level=1):
        self._check_unported()
        device = self._device()
        train_output_path = Path(train_output_path)
        dev_output_path = Path(dev_output_path)
        (dev_best_fn, weights_path, info_path, loss_fn_path, metrics_fn) = self.get_paths_for_early_stopping(
            train_output_path, dev_output_path
        )
        self._loss_fn()
        self._check_loss_support(reranker)
        batch_size = self.config["batch"]
        gradacc = self.config["gradacc"]

        negrefresh = int(self.config.get("negrefresh") or 0)
        if negrefresh > 0 and not getattr(train_dataset, "supports_hard_negative_refresh", False):
            raise ConfigError(
                f"trainer.negrefresh needs a sampler whose stream reads live negative pools "
                f"(triplet/pair/LCE); {type(train_dataset).module_name} does not support it")
        train_iter = iter(train_dataset)
        # the JAX trainer draws one batch to initialise its params; the stream
        # position (and so every later batch) is the same here
        first_samples = [next(train_iter) for _ in range(batch_size)]
        if self.config["loss"] == "margin_mse" and "teacher_margin" not in first_samples[0]:
            raise ConfigError("trainer.loss=margin_mse needs per-triple teacher margins "
                              "in the samples; use sampler.name=distill with a teacher "
                              "run file (sampler.teacherrunfile)")
        model = reranker.init_params(self.config["seed"]).to(device)
        optimizer = self.make_optimizer(reranker, model)

        initial_iter = 0
        train_loss = []
        if self.config["fastforward"]:
            initial_iter, train_loss = self._fastforward(weights_path, loss_fn_path, model, optimizer, reranker)
            if initial_iter > 0:
                logger.info("fastforwarding to iteration %d", initial_iter)
                # the stream already yielded batch_size samples for init; skip the rest
                remaining = initial_iter * self.steps_per_iter * gradacc * batch_size - batch_size
                for _ in range(max(0, remaining)):
                    next(train_iter)
        self._model, self._optimizer = model, optimizer

        pending = first_samples if initial_iter == 0 else []
        from capreolus_tpu_torch.utils.tensorboard import EventWriter

        tb = None
        try:
            tb = EventWriter(Path(constants["RESULTS_BASE_PATH"]) / "runs" / self.config["boardname"])
        except Exception as e:
            logger.debug("tensorboard writer unavailable: %s", e)
        best_metric = -np.inf
        if metrics_fn.exists():
            best_metric = self.load_best_metric(metrics_fn, metric)
        dev_best_metrics = {}

        # background prefetch: host sample generation and collation overlap the device steps
        batch_queue: _queue.Queue = _queue.Queue(maxsize=4)
        total_steps = (self.config["niters"] - initial_iter) * self.steps_per_iter
        stop_flag = []

        def _producer():
            try:
                pending_local = list(pending)
                need = gradacc * batch_size
                for _ in range(total_steps):
                    if stop_flag:
                        return
                    while len(pending_local) < need:
                        pending_local.append(next(train_iter))
                    batch = collate(pending_local[:need], ARRAY_KEYS)
                    del pending_local[:need]
                    batch_queue.put({k: v.reshape((gradacc, batch_size) + v.shape[1:]) for k, v in batch.items()})
            except BaseException as e:  # surface producer failures to the train loop
                batch_queue.put(e)

        producer = threading.Thread(target=_producer, daemon=True)
        producer.start()

        profiler = None
        try:
            for niter in range(initial_iter, self.config["niters"]):
                if self.config["profile"] and niter == initial_iter:
                    profiler = self._start_profile(device)
                iter_start = time.time()
                model.train()
                iter_loss = []
                for step_i in range(self.steps_per_iter):
                    item = batch_queue.get()
                    if isinstance(item, BaseException):
                        raise item
                    step = niter * self.steps_per_iter + step_i
                    iter_loss.append(self.train_step(reranker, model, optimizer, item, step,
                                                     self.step_seed(niter, step_i)))
                train_loss.append(float(np.mean([float(x) for x in iter_loss])))
                logger.info("iter=%d loss=%.6f (%.1fs)", niter, train_loss[-1], time.time() - iter_start)
                if tb is not None:
                    tb.add_scalar("training/loss", train_loss[-1], niter)
                if profiler is not None:
                    self._stop_profile(profiler, info_path / "profile")
                    profiler = None

                if self.config["fastforward"]:
                    self.save_checkpoint(weights_path / f"{niter}", model, optimizer, reranker)
                self.write_to_loss_file(loss_fn_path, train_loss)

                if (niter + 1) % self.config["validatefreq"] == 0 and dev_data is not None:
                    preds = self.predict(reranker, dev_data)
                    metrics = eval_runs(preds, qrels, self._validation_metrics(metric), relevance_level)
                    logger.info("dev metrics: %s", " ".join(f"{k}={v:0.3f}" for k, v in sorted(metrics.items())))
                    if tb is not None:
                        for name, value in metrics.items():
                            tb.add_scalar(f"dev/{name}", value, niter)
                        self._tb_histograms(tb, model, niter)
                    if metrics[metric] > best_metric:
                        best_metric = metrics[metric]
                        logger.info("new best dev metric: %s=%0.3f", metric, best_metric)
                        dev_best_metrics = metrics
                        self.write_to_metric_file(metrics_fn, metrics)
                        self.save_checkpoint(dev_best_fn, model, optimizer, reranker)
                        try:
                            reranker.add_summary(niter, info_path / "summaries")
                        except Exception as e:
                            logger.debug("add_summary failed: %s", e)

                # ANCE-style refresh: re-score the ORIGINAL candidate pools with the
                # CURRENT model and hand the sampler the hardest negatives (the
                # producer thread reads the swapped pools on its next draws);
                # skipped after the final iteration
                if negrefresh and (niter + 1) % negrefresh == 0 and (niter + 1) < self.config["niters"]:
                    train_dataset.set_hard_negatives(self._mine_hard_negatives(reranker, train_dataset))
        finally:
            stop_flag.append(True)
            if profiler is not None:
                profiler.stop()
            if tb is not None:
                tb.close()
        return dev_best_metrics

    @staticmethod
    def _start_profile(device):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    @staticmethod
    def _stop_profile(profiler, out_dir):
        profiler.stop()
        out_dir.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(out_dir / "trace.json"))
        logger.info("profiler trace written to %s", out_dir)

    @classmethod
    def _tb_histograms(cls, tb, model, niter):
        """Per-parameter weight histograms, skipped above ~4M parameters."""
        from capreolus_tpu_torch.convert import flax_flat_params

        if sum(p.numel() for p in model.parameters()) > cls._TB_HISTOGRAM_PARAM_LIMIT:
            return
        for name, value in flax_flat_params(model).items():
            tb.add_histogram(name, value, niter)

    @staticmethod
    def _validation_metrics(metric):
        base = ["map", "P_20", "ndcg_cut_20"]
        return base if metric in base else base + [metric]

    def _mine_hard_negatives(self, reranker, train_dataset):
        """Score every (qid, candidate) pair of the train sampler's ORIGINAL
        negative pools with the current model and return the top ``neghard``
        per query; the mining sampler is cached on the train sampler so its
        features are extracted once per fold."""
        mining = getattr(train_dataset, "_mining_sampler", None)
        if mining is None:
            from capreolus_tpu_torch.sampler import Sampler

            pool = train_dataset.hard_negative_pool()
            mining = Sampler.create("pred", {})
            # empty qrels per qid: everything in the pool is already non-relevant
            mining.prepare(pool, {qid: {} for qid in pool}, train_dataset.extractor)
            train_dataset._mining_sampler = mining
        preds = self.predict(reranker, mining)
        return select_hard_negatives(preds, int(self.config["neghard"]))

    def predict(self, reranker, pred_data, pred_fn=None):
        """Score all (qid, docid) pairs of a PredSampler with the trained (or
        loaded) model; returns {qid: {docid: score}} and writes a TREC run file
        to ``pred_fn`` when given."""
        self._check_unported()
        device = self._device()
        if self._model is None:
            raise RuntimeError("predict() needs a model: train() or load_best_model() first")
        batch_size = int(self.config.get("evalbatch") or 0) or self.config["batch"]
        sample_iter = self._predict_samples(pred_data)
        preds = {}
        pending = collections.deque()

        def _drain_one():
            scores, pairs = pending.popleft()
            for (qid, docid), score in zip(pairs, scores.cpu().numpy()):
                preds.setdefault(qid, {})[docid] = float(score)

        was_training = self._model.training
        self._model.eval()
        prepared = False
        with torch.no_grad():
            while True:
                chunk = list(itertools.islice(sample_iter, batch_size))
                if not chunk:
                    break
                batch = collate(chunk, ARRAY_KEYS)
                if not prepared:
                    prepared = True
                    if hasattr(reranker, "prepare_inference"):
                        # int8 calibration against the current weights, every predict
                        reranker.prepare_inference(batch, device)
                pending.append((reranker.test(batch, device), [(s["qid"], s["posdocid"]) for s in chunk]))
                if len(pending) >= PREDICT_PIPELINE_DEPTH:
                    _drain_one()
            while pending:
                _drain_one()
        self._model.train(was_training)

        if pred_fn is not None:
            from capreolus_tpu_torch.utils.trec import write_trec_run

            pred_fn = Path(pred_fn)
            pred_fn.parent.mkdir(parents=True, exist_ok=True)
            write_trec_run(preds, pred_fn)
        return preds

    def _predict_samples(self, pred_data):
        """An iterator over pred samples, materialized and cached on the sampler
        only when they fit PREDICT_CACHE_BYTES (dev sets during validation:
        cached across rounds; big test folds: streamed once)."""
        cached = getattr(pred_data, "_materialized_samples", None)
        if cached is not None:
            return iter(cached)
        it = iter(pred_data)
        first = next(it, None)
        if first is None:
            return iter(())
        it = itertools.chain([first], it)
        per_sample = sum(np.asarray(first[k]).nbytes for k in ARRAY_KEYS if k in first)
        try:
            total = per_sample * len(pred_data)
        except TypeError:  # no __len__: stream
            total = None
        if total is not None and total <= self.PREDICT_CACHE_BYTES:
            samples = list(it)
            try:
                pred_data._materialized_samples = samples
            except AttributeError:
                pass
            return iter(samples)
        logger.info("streaming %s prediction samples (%.1f GiB of features exceeds the %d GiB cache budget)",
                    "unknown-count" if total is None else len(pred_data),
                    0.0 if total is None else total / 2**30, self.PREDICT_CACHE_BYTES >> 30)
        return it

    # ------------------------------------------------------------------ checkpoints
    @staticmethod
    def saveable_params(reranker, model):
        """The JAX parameter tree of ``model``, frozen leaves empty, every
        level's keys sorted: the tree the JAX trainer writes (its
        ``_strip_frozen`` is a ``tree_map``, which rebuilds dicts in key order)."""
        from capreolus_tpu_torch.convert import flax_flat_params, unflatten_tree

        def sort(tree):
            return {k: sort(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}

        flat = flax_flat_params(model)
        return sort(unflatten_tree({k: (v if reranker is None or reranker.trainable(tuple(k.split("/")), v)
                                        else np.zeros(0, dtype=np.float32)) for k, v in flat.items()}))

    def save_checkpoint(self, path, model, optimizer, reranker):
        from capreolus_tpu_torch.utils.flax_msgpack import to_bytes

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        _ext(path, ".params").write_bytes(to_bytes(self.saveable_params(reranker, model)))
        if optimizer is not None:
            torch.save(optimizer.state_dict(), _ext(path, ".optstate"))
        _ext(path, ".done").write_text("done")

    def load_checkpoint(self, path, model, optimizer, reranker):
        """Restore ``<path>.params`` (either trainer's) into ``model`` through
        ``reranker.state_dict_from_params``, which refills the frozen leaves a
        checkpoint leaves empty with their values (``_merge_frozen``: a frozen
        KNRM's extractor table and kernel bank); and this trainer's
        ``<path>.optstate`` into ``optimizer`` when given."""
        from capreolus_tpu_torch.convert import _flax_leaves, _present, load_params

        flat = load_params(_ext(path, ".params"))
        params = dict(model.named_parameters())
        missing = [key for key, name, _ in _flax_leaves(model)
                   if reranker.trainable(tuple(key.split("/")), params[name]) and not _present(flat, key)]
        if missing:
            raise KeyError(f"checkpoint {path} lacks trainable parameters {missing[:3]}...")
        own = model.state_dict()  # an f32 training model of an int8 reranker has no int8 stats
        try:
            model.load_state_dict({k: v for k, v in reranker.state_dict_from_params(flat).items() if k in own})
        except RuntimeError as e:
            raise RuntimeError(f"checkpoint {path} does not fit the model (a vocabulary-sized table needs the "
                               f"training-time extractor state): {e}") from e
        opt_fn = _ext(path, ".optstate")
        if optimizer is not None and opt_fn.exists():
            optimizer.load_state_dict(torch.load(opt_fn, map_location=next(model.parameters()).device,
                                                 weights_only=True))
        return model, optimizer

    def _fastforward(self, weights_path, loss_fn_path, model, optimizer, reranker):
        if not loss_fn_path.exists():
            return 0, []
        try:
            losses = self.load_loss_file(loss_fn_path)
        except IOError as e:
            logger.warning("%s", e)
            return 0, []
        for niter in range(len(losses) - 1, -1, -1):
            ckpt = weights_path / f"{niter}"
            if _ext(ckpt, ".done").exists():
                self.load_checkpoint(ckpt, model, optimizer, reranker)
                return niter + 1, losses[: niter + 1]
        return 0, []

    def load_best_model(self, reranker, train_output_path):
        """Load the ``dev.best`` weights into the reranker's model (built and
        initialised from seed 0 when this trainer has none yet, as the JAX
        task builds a template from ``PRNGKey(0)``)."""
        if self._model is None:
            self._model = reranker.init_params(0).to(self._device())
        self.load_checkpoint(Path(train_output_path) / "dev.best", self._model, None, reranker)
        return self._model


@Trainer.register
class PytorchTrainerAlias(TorchTrainer):
    """``trainer.name=pytorch`` of the reference's configs."""

    module_name = "pytorch"


@Trainer.register
class TensorflowTrainerAlias(TorchTrainer):
    """``trainer.name=tensorflow`` of the reference's configs."""

    module_name = "tensorflow"
