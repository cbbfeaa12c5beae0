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
- ``amp``: ``train`` and ``both`` run each training forward and its backward
  on every f32 weight rounded to bf16, the gradient passing back through the
  rounding to the f32 weights Adam updates; ``pred`` and ``both`` predict with
  rounded weights (``trainer/amp.py``: the JAX trainer's cast of its parameter
  tree, not ``torch.autocast``). TF32 stays off at every mode. With
  ``quantize=int8`` the int8 model calibrates on the f32 weights, then its
  weights and GELU stats are rounded and its weights quantized in bf16, as
  the JAX trainer's ``_amp_pred_params`` leaves them. cuDNN's convolutions
  and recurrences (the zoo's) stay in f32 through each step's backward too
  (``cudnn_f32``).
- Figures: ``info/loss.png`` after every iteration and ``info/metrics.png``
  after every validation, with matplotlib when it imports (best-effort, as
  in JAX: nothing is written without it).
- Checkpoints: ``<path>.params`` in flax's msgpack bytes of the JAX parameter
  tree (``utils/flax_msgpack.py``), frozen leaves written empty and keys in
  the order the JAX trainer writes them, so a
  ``dev.best`` of either trainer loads in the other package;
  ``<path>.optstate`` is the torch optimizer's state, read only by this
  trainer's fastforward; ``<path>.done`` marks a complete checkpoint.

The trainer runs on ``self.device`` (an attribute, not a config option, so it
never enters the results path; ``None`` means "cuda"), which the rerank task
sets, and over ``self.devices`` (likewise an attribute; ``None`` means every
visible CUDA device when ``device`` is CUDA, else ``[device]``). ``_mesh``
builds the JAX trainer's mesh over them, with its rules and messages: the
batch over ``data`` (the data axis shrinking until it divides the batch),
and ``tp`` over ``model``, ``pp`` over ``pipe`` (with tp, the 3D (data, pipe,
model) mesh), ``ep`` over ``expert``; ``fsdp`` shards the state over
``data``; ``sp`` splits the tokens over ``model``. One device is no mesh:
the single-device path. On a mesh the weights live in a
``parallel/placement.py`` ``Placement`` (one process, explicit per-device
tensors): each training step cuts every micro-batch over the data shards,
runs each shard's forward on its devices, gathers the outputs to the first
device for the loss of the whole batch (``mesh_loss``), and autograd sums
the gradients back into the placement's blocks, which Adam steps;
predictions are cut over the data shards the same way. Each data shard's
dropout seed is the step's folded with its index. ``ckpt=sharded`` and
``sharded_async`` write the JAX package's sharded directories
(``utils/sharded_ckpt.py``), in async mode from a background thread; on a
mesh a sharded leaf is written as its blocks and restored onto the
placement's own layout, whatever layout wrote it.
Validation metrics run on the trainer's device when every metric is
supported (``evaluation/device_metrics.py``), as the JAX trainer's do.

``loss=infonce`` trains a reranker with ``encode`` (the biencoder) on the
in-batch similarity matrix: f32 ``q @ pos.T``, each sample's hard negative
appended as ``q @ neg.T``, times the reranker's ``scale``, against the labels
``arange(B)``. It needs a triplet-form stream. A reranker with a
``regularizer`` (SPLADE's FLOPS penalty) adds it to every training loss.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import queue as _queue
import threading
import time
from pathlib import Path

import numpy as np
import torch

from capreolus_tpu_torch.core import ConfigError, ConfigOption, constants
from capreolus_tpu_torch.evaluation import eval_runs
from capreolus_tpu_torch.reranker.common import LOSS_FUNCTIONS, cudnn_f32, matmul_f32
from capreolus_tpu_torch.trainer import Trainer
from capreolus_tpu_torch.trainer.amp import amp_mode, bf16_params, round_int8_inference
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


def _plot_loss(losses, path):
    """The loss curve as a figure (best-effort: nothing without matplotlib)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(range(len(losses)), losses)
        ax.set_xlabel("iteration")
        ax.set_ylabel("loss")
        fig.savefig(path, dpi=80)
        plt.close(fig)
    except Exception as e:  # plotting must never break training
        logger.debug("loss figure not written: %s", e)


def _plot_metrics(history, path):
    """The dev-metric curves of [(iteration, {metric: value})] as a figure
    (best-effort: nothing without matplotlib)."""
    if not history:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        iters = [it for it, _ in history]
        for name in sorted(history[0][1]):
            ax.plot(iters, [m[name] for _, m in history], label=name)
        ax.set_xlabel("iteration")
        ax.set_ylabel("metric")
        ax.legend()
        fig.savefig(path, dpi=80)
        plt.close(fig)
    except Exception as e:  # plotting must never break training
        logger.debug("metrics figure not written: %s", e)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _optimizer_tree(state_dict):
    """A torch optimizer's ``state_dict`` as a tree ``save_sharded`` writes:
    each parameter's state tensors under its index, the param groups as the
    bytes of their JSON."""
    return {"state": {str(i): dict(st) for i, st in state_dict["state"].items()},
            "param_groups": np.frombuffer(json.dumps(state_dict["param_groups"]).encode(), np.uint8)}


def _optimizer_state_dict(tree):
    """The inverse of ``_optimizer_tree`` over ``load_sharded``'s numpy tree
    (JSON lists other than ``params``, Adam's ``betas``, back to tuples)."""
    groups = json.loads(np.asarray(tree["param_groups"], np.uint8).tobytes())
    return {"state": {int(i): {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
                      for i, st in tree.get("state", {}).items()},
            "param_groups": [{k: tuple(v) if isinstance(v, list) and k != "params" else v for k, v in g.items()}
                             for g in groups]}


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
                     "to one host), sharded (per-shard raw .npy in the JAX package's manifest "
                     "format; one shard per leaf on one device), or sharded_async (sharded + "
                     "background file writes off the train loop)"),
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
        ConfigOption("tp", 1, "tensor-parallel degree: shard BERT matmuls over a 'model' mesh axis "
                     "(Megatron-style column/row split; for bert-large/PARADE-large)"),
        ConfigOption("pp", 1, "pipeline-parallel degree: split the BERT layer stack into stages over "
                     "a 'pipe' mesh axis (GPipe microbatched schedule; each device stores only its "
                     "stage's layers); composes with tp>1 into a 3D (data, pipe, model) mesh where "
                     "each stage's matmuls are Megatron-sharded"),
        ConfigOption("ep", 1, "expert-parallel degree: shard MoE expert weights (reranker.moeexperts>0) "
                     "over an 'expert' mesh axis; each device computes its experts' FFNs and the gated "
                     "outputs are summed back (parallel/expert_parallel.py)"),
        ConfigOption("sp", False, "sequence parallelism (requires tp>1): shard the token axis over the "
                     "'model' mesh axis so token-independent work (embeddings, layernorm, residuals, "
                     "dropout) runs sequence-sharded; tokens are gathered only before the column-parallel "
                     "matmuls (Megatron-SP semantics)"),
        ConfigOption("microbatches", 0, "pipeline microbatches per step (0 = auto: largest divisor "
                     "of the per-data-shard batch <= 2*pp)"),
        ConfigOption("fsdp", False, "fully-sharded data parallelism (ZeRO-3): shard every parameter, "
                     "gradient, and Adam moment over the 'data' mesh axis along its largest divisible "
                     "dim; weights are gathered at use and gradients reduce-scattered "
                     "(parallel/fsdp.py). Each device stores 1/dp of model+optimizer state"),
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
    # the devices a mesh may span (not a config option: config keys change result paths); None means
    # every visible CUDA device when ``device`` is CUDA, else ``[device]``; a list may repeat a device
    devices = None
    PREDICT_CACHE_BYTES = 2 << 30  # materialize+cache pred features up to 2 GiB
    _TB_HISTOGRAM_PARAM_LIMIT = 1 << 22  # ~4M params

    def build(self):
        self._model = None
        self._optimizer = None
        self._data_mesh = None
        self._placement = None
        self.device_validations = 0  # validations whose metrics ran on the device

    # ------------------------------------------------------------------ setup
    def _device(self):
        from capreolus_tpu_torch.serving import resolve_device

        return resolve_device(self.device)

    def _check_options(self):
        self._ckpt_mode()
        amp_mode(self.config["amp"])

    def _devices(self):
        """The devices a mesh may span: ``self.devices``, else every visible
        CUDA device when the trainer's device is CUDA, else that device."""
        from capreolus_tpu_torch.parallel.distributed import normalize_device, visible_devices

        if self.devices is not None:
            return [normalize_device(d) for d in self.devices]
        device = self._device()
        return visible_devices() if device.type == "cuda" else [device]

    def _mesh(self, batch_size):
        """The device mesh, with the JAX trainer's rules and messages: 1D
        ("data",) for data parallelism, ("data", "model") when tp>1, ("data",
        "pipe") or ("data", "pipe", "model") when pp>1, ("data", "expert") when
        ep>1; the data axis shrinks until it divides ``batch_size``. None on
        one device (the single-device path)."""
        from capreolus_tpu_torch.parallel.distributed import Mesh

        devices = self._devices()
        n = len(devices)
        c = self.config
        tp, pp, ep = int(c.get("tp", 1)), int(c.get("pp", 1)), int(c.get("ep", 1))

        def mesh(count, shape, names):
            arr = np.empty(count, dtype=object)
            arr[:] = devices[:count]
            return Mesh(arr.reshape(shape), names)

        def data_size(per):
            dp = n // per
            while dp > 1 and batch_size % dp != 0:
                dp -= 1
            return dp

        if c.get("fsdp") and (tp > 1 or pp > 1 or ep > 1):
            raise ConfigError("trainer.fsdp shards state over the pure-DP 'data' mesh; "
                              "it cannot be combined with tp/pp/ep")
        if ep > 1:
            if tp > 1 or pp > 1:
                raise ConfigError("trainer.ep cannot be combined with tp/pp yet; pick one")
            if n % ep != 0:
                raise ConfigError(f"trainer.ep={ep} does not divide the {n} available devices")
            dp = data_size(ep)
            return mesh(dp * ep, (dp, ep), ("data", "expert"))
        if c.get("sp") and tp <= 1:
            raise ConfigError("trainer.sp=True requires trainer.tp>1 (sequence shards ride the "
                              "'model' mesh axis, Megatron-SP style)")
        if pp > 1:
            if c.get("sp"):
                raise ConfigError("trainer.sp cannot be combined with trainer.pp yet")
            if n % (pp * tp) != 0:
                raise ConfigError(f"trainer.pp={pp} x trainer.tp={tp} does not divide the "
                                  f"{n} available devices")
            dp = data_size(pp * tp)
            if tp > 1:
                return mesh(dp * pp * tp, (dp, pp, tp), ("data", "pipe", "model"))
            return mesh(dp * pp, (dp, pp), ("data", "pipe"))
        if tp > 1:
            if n % tp != 0:
                raise ConfigError(f"trainer.tp={tp} does not divide the {n} available devices")
            dp = data_size(tp)
            return mesh(dp * tp, (dp, tp), ("data", "model"))
        while n > 1 and batch_size % n != 0:
            n -= 1
        if n <= 1:
            return None
        return mesh(n, (n,), ("data",))

    def _mesh_kind(self, mesh):
        """The placement of ``mesh`` and its log line's name."""
        axes = mesh.axis_names
        if "pipe" in axes:
            return "pp", "pipeline+tensor+data-parallel" if "model" in axes else "pipeline+data-parallel"
        if "model" in axes:
            return "tp", "tensor+data-parallel"
        if "expert" in axes:
            return "ep", "expert+data-parallel"
        if self.config.get("fsdp"):
            return "fsdp", "fully-sharded data-parallel (ZeRO-3)"
        return "dp", "data-parallel"

    def _pp_setup(self, reranker, model, trainable):
        """The pipeline placement, with the JAX trainer's refusals."""
        from capreolus_tpu_torch.parallel.placement import Placement

        if not getattr(reranker, "pp_compatible", False):
            raise ConfigError(
                f"trainer.pp>1 supports plain-BERT cross-encoders (BERTMaxP/TFVanillaBERT); "
                f"{type(reranker).module_name} is not pipeline-compatible")
        if self.config["loss"] == "lce":
            raise ConfigError("trainer.pp>1 does not support loss=lce yet")
        if self.config["loss"] == "infonce":
            raise ConfigError("trainer.loss=infonce is not wired through the GPipe schedule "
                              "(score_pp returns pair scores, not embeddings); use dp/tp/fsdp")
        num_layers = reranker.build_train_model().config.num_layers
        pp = int(self.config["pp"])
        if num_layers % pp != 0:
            raise ConfigError(f"trainer.pp={pp} does not divide the {num_layers} encoder layers")
        return Placement(model, self._data_mesh, "pp", trainable, amp=self.amp_train(),
                         microbatches=self.config.get("microbatches", 0))

    def _place_params(self, reranker, model):
        """The trainer's placement of ``model`` on ``self._data_mesh`` (None
        without a mesh): replicated (DP), Megatron column / row-split over
        ``model`` (tp>1), expert-split (ep>1), ZeRO-3 over ``data`` (fsdp) or
        the GPipe stages (pp>1). Logs the kind and the mesh, as JAX does."""
        from capreolus_tpu_torch.convert import flax_leaves
        from capreolus_tpu_torch.parallel.placement import Placement

        mesh = self._data_mesh
        if mesh is None:
            return None
        kind, label = self._mesh_kind(mesh)
        logger.info("%s training over %d devices (mesh %s)", label, mesh.devices.size, mesh.shape)
        params = dict(model.named_parameters())
        trainable = [key for key, name, *_ in flax_leaves(model)
                     if reranker.trainable(tuple(key.split("/")), params[name])]
        if kind == "pp":
            return self._pp_setup(reranker, model, trainable)
        return Placement(model, mesh, kind, trainable, sp=bool(self.config.get("sp")), amp=self.amp_train())

    def _ckpt_mode(self):
        mode = str(self.config.get("ckpt", "flat"))
        if mode not in ("flat", "sharded", "sharded_async"):
            raise ConfigError(f"trainer.ckpt must be flat, sharded, or sharded_async (got {mode!r})")
        return mode

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
        from capreolus_tpu_torch.convert import flax_leaves

        params = dict(model.named_parameters())
        labels = {}
        for key, name, *_ in flax_leaves(model):
            path = tuple(key.split("/"))
            if not reranker.trainable(path, params[name]):
                labels[name] = "frozen"
            elif "bert" in key.lower() or "electra" in key.lower():
                labels[name] = "bert"
            else:
                labels[name] = "other"
        return labels

    def make_optimizer(self, reranker, model, placement=None):
        """Adam over the trainable parameters in the ``other`` and ``bert``
        groups; frozen parameters stop requiring grad and stay outside. With
        a ``placement`` the groups hold its blocks (each leaf's distinct
        blocks, on their devices), so Adam's moments are per block."""
        labels = self.param_labels(reranker, model)
        groups = {"other": [], "bert": []}
        for name, p in model.named_parameters():
            if labels[name] == "frozen":
                p.requires_grad_(False)
            elif placement is None:
                groups[labels[name]].append(p)
        if placement is not None:
            for key in placement.store:
                name = placement.leaves[key][0] if key in placement.leaves else \
                    placement.leaves[placement.stacked_from(key)[0]][0]
                if labels[name] != "frozen":
                    groups[labels[name]].extend(placement.store[key].blocks.values())
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
        if self.config["loss"] == "infonce" and not hasattr(reranker, "encode"):
            raise ConfigError(
                f"trainer.loss=infonce needs a reranker exposing embeddings (encode); "
                f"{type(reranker).module_name} does not support it (use reranker.name=biencoder)")

    def _check_infonce_stream(self, first_sample, train_dataset):
        """infonce treats every sample's posdoc as a true positive (the
        diagonal labels) and its negdoc as one hard negative: a pair stream
        (pos and neg alternate in the posdoc slot, a zeros negdoc with an
        empty negdocid) or an LCE stream (nneg stacked negatives) would train
        on a corrupted objective, so both are refused."""
        neg0 = first_sample.get("negdoc")
        if neg0 is None or np.asarray(neg0).ndim != 1 or not first_sample.get("negdocid"):
            raise ConfigError(
                "trainer.loss=infonce needs a triplet-form stream (one true positive in "
                "posdoc plus a single hard negative in negdoc per sample); use "
                f"sampler.name=triplet or distill — sampler.name="
                f"{type(train_dataset).module_name} is incompatible (pair alternates "
                "pos/neg in the posdoc slot; LCE stacks nneg negatives per sample)")

    def amp_train(self):
        """Whether training forwards run on bf16-rounded weights (amp train or both)."""
        return amp_mode(self.config["amp"]) in ("train", "both")

    def amp_pred(self):
        """Whether predictions run on bf16-rounded weights (amp pred or both)."""
        return amp_mode(self.config["amp"]) in ("pred", "both")

    def compute_loss(self, reranker, micro, device, dropout_seed=None):
        """The training loss of one micro-batch (a training forward)."""
        kwargs = {"dropout_seed": dropout_seed} if reranker.accepts_rngs else {}
        return self._loss_of(reranker, micro, device, self._forward(reranker, micro, device, kwargs), kwargs)

    def _forward(self, reranker, micro, device, kwargs):
        """The training forward's outputs of one micro-batch: (scores,) for
        lce, (q, pos, neg, scale) for infonce, else (pos, neg)."""
        name = self.config["loss"]
        if name == "lce":
            return (reranker.score_lce(micro, device, **kwargs),)
        if name == "infonce":
            return tuple(reranker.encode(micro, device, **kwargs))
        return tuple(reranker.score(micro, device, **kwargs))

    def _loss_of(self, reranker, micro, device, outputs, kwargs):
        """The loss of ``_forward``'s outputs over ``micro``, plus the reranker's regularizer."""
        loss_fn = self._loss_fn()
        name = self.config["loss"]
        if name == "lce":
            loss = loss_fn(outputs[0], None)
        elif name == "infonce":
            q, pos, neg, scale = outputs
            logits = q.float() @ pos.float().T
            if neg is not None:
                logits = torch.cat([logits, q.float() @ neg.float().T], dim=1)
            loss = loss_fn(scale * logits, torch.arange(logits.shape[0], device=logits.device))
        else:
            pos, neg = outputs
            if name == "crossentropy":
                loss = loss_fn(torch.stack([neg, pos], dim=1).float(), reranker.put(micro, "label", device))
            elif name == "margin_mse":
                loss = loss_fn(pos.float().reshape(-1), neg.float().reshape(-1),
                               reranker.put(micro, "teacher_margin", device).float().reshape(-1))
            else:
                loss = loss_fn([pos.float(), neg.float()])
        if hasattr(reranker, "regularizer"):
            loss = loss + reranker.regularizer(micro, device, **kwargs)
        return loss

    def mesh_loss(self, reranker, micro, dropout_seed=None):
        """The training loss of one micro-batch over the placement's data
        shards: each shard's forward on its first device (its seed folded
        with the shard index), the outputs gathered to the first shard's
        device, and the loss of the whole micro-batch there, as GSPMD
        computes the global batch's loss. Run inside ``placement.bind()``."""
        from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

        placement = self._placement
        lead = placement.lead(0)
        parts = []
        for r, (device, shard) in enumerate(placement.split(micro)):
            seed = None if dropout_seed is None else dropout_generator_seed(dropout_seed, r)
            kwargs = {"dropout_seed": seed} if reranker.accepts_rngs else {}
            parts.append(self._forward(reranker, shard, device, kwargs))
        outputs = []
        for pieces in zip(*parts):
            if pieces[0] is None or not torch.is_tensor(pieces[0]) or pieces[0].dim() == 0:
                outputs.append(pieces[0].to(lead) if torch.is_tensor(pieces[0]) else pieces[0])
            else:
                outputs.append(torch.cat([x.to(lead) for x in pieces]))
        kwargs = {"dropout_seed": dropout_seed} if reranker.accepts_rngs else {}
        return self._loss_of(reranker, micro, lead, tuple(outputs), kwargs)

    def train_step(self, reranker, model, optimizer, batches, step, step_seed):
        """One optimizer step over ``batches`` ([gradacc, batch, ...] arrays) at
        optimizer step ``step``; returns the mean micro-batch loss (a tensor).
        With a placement, each micro-batch's loss is ``mesh_loss``'s."""
        placement = self._placement
        device = placement.lead(0) if placement is not None else next(model.parameters()).device
        gradacc = self.config["gradacc"]
        optimizer.zero_grad(set_to_none=True)
        from capreolus_tpu_torch.reranker.bert.encoder import dropout_generator_seed

        loss_sum = torch.zeros((), device=device)
        for g in range(gradacc):
            micro = {k: v[g] for k, v in batches.items()}
            seed = dropout_generator_seed(step_seed, g)
            # around the backward too: remat recomputes layers, and cuDNN's backward reads the TF32 flag
            if placement is not None:
                with placement.bind(), cudnn_f32(), matmul_f32():
                    loss = self.mesh_loss(reranker, micro, seed)
                    loss.backward()
            else:
                with bf16_params(model, self.amp_train()), cudnn_f32(), matmul_f32():
                    loss = self.compute_loss(reranker, micro, device, seed)
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
        self._check_options()
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
        if self.config["loss"] == "infonce":
            self._check_infonce_stream(first_samples[0], train_dataset)
        model = reranker.init_params(self.config["seed"]).to(device)
        # the mesh, as the JAX trainer's: the batch over 'data', the weights placed as its kind says
        self._data_mesh = self._mesh(batch_size)
        self._placement = self._place_params(reranker, model)
        optimizer = self.make_optimizer(reranker, model, self._placement)

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
        metric_history = []

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
                _plot_loss(train_loss, info_path / "loss.png")

                if (niter + 1) % self.config["validatefreq"] == 0 and dev_data is not None:
                    preds = self.predict(reranker, dev_data)
                    metrics = self._eval_dev_runs(preds, qrels, self._validation_metrics(metric), relevance_level)
                    logger.info("dev metrics: %s", " ".join(f"{k}={v:0.3f}" for k, v in sorted(metrics.items())))
                    metric_history.append((niter, dict(metrics)))
                    _plot_metrics(metric_history, info_path / "metrics.png")
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
        if self._placement is not None:
            self._placement.sync_model()  # the canonical weights, as the JAX trainer keeps _params
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

    def _eval_dev_runs(self, preds, qrels, metrics, relevance_level):
        """Validation metrics on the trainer's device when every metric is
        supported (``evaluation/device_metrics.py``), the host's ``eval_runs``
        otherwise, as the JAX trainer chooses; ``device_validations`` counts
        the validations that took the device path."""
        from capreolus_tpu_torch.evaluation.device_metrics import device_supported, eval_runs_device

        if device_supported(metrics):
            self.device_validations += 1
            return eval_runs_device(preds, qrels, metrics, relevance_level, device=self._device())
        return eval_runs(preds, qrels, metrics, relevance_level)

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

    def _prediction_placement(self, reranker):
        """The placement predictions run on, after the model's own weights are
        made the store's (the canonical tree): the training placement, except
        under pp, where the canonical tree is replicated over the data shards'
        first devices, as the JAX trainer predicts on its canonical tree. None
        (the whole batch on the trainer's device) without a mesh, and for an
        int8 reranker or amp predictions, whose scoring model is rounded or
        quantized from the canonical weights."""
        from capreolus_tpu_torch.parallel.distributed import Mesh
        from capreolus_tpu_torch.parallel.placement import Placement

        placement = self._placement
        if placement is None:
            return None
        placement.sync_model()
        if getattr(reranker, "quantized", False) or self.amp_pred():
            return None
        if placement.kind != "pp":
            return placement
        leads = np.empty(placement.dp, dtype=object)
        leads[:] = [placement.lead(r) for r in range(placement.dp)]
        return Placement(self._model, Mesh(leads, ("data",)), "dp")

    def predict(self, reranker, pred_data, pred_fn=None):
        """Score all (qid, docid) pairs of a PredSampler with the trained (or
        loaded) model; returns {qid: {docid: score}} and writes a TREC run file
        to ``pred_fn`` when given. On a mesh (``_prediction_placement``) each
        batch is cut over the data shards, the last one padded with its last
        sample to a multiple of them, and each shard scored on its devices."""
        self._check_options()
        device = self._device()
        if self._model is None:
            raise RuntimeError("predict() needs a model: train() or load_best_model() first")
        batch_size = int(self.config.get("evalbatch") or 0) or self.config["batch"]
        sample_iter = self._predict_samples(pred_data)
        preds = {}
        pending = collections.deque()
        placement = self._prediction_placement(reranker)

        def _drain_one():
            scores, pairs = pending.popleft()
            for (qid, docid), score in zip(pairs, scores.cpu().numpy()):
                preds.setdefault(qid, {})[docid] = float(score)

        def score(chunk):
            if placement is None:
                return reranker.test(collate(chunk, ARRAY_KEYS), device)
            n = len(chunk)
            chunk = chunk + chunk[-1:] * ((-n) % placement.dp)
            lead = placement.lead(0)
            with placement.bind():
                parts = [reranker.test(shard, d) for d, shard in placement.split(collate(chunk, ARRAY_KEYS))]
            return torch.cat([x.to(lead) for x in parts])[:n]

        was_training = self._model.training
        self._model.eval()
        prepared = False
        with torch.no_grad(), matmul_f32(), contextlib.ExitStack() as amp:
            while True:
                chunk = list(itertools.islice(sample_iter, batch_size))
                if not chunk:
                    break
                if not prepared:
                    prepared = True
                    batch = collate(chunk, ARRAY_KEYS)
                    if hasattr(reranker, "prepare_inference"):
                        # int8 calibration against the current f32 weights, every predict
                        reranker.prepare_inference(batch, device)
                    if self.amp_pred():  # the weights the scoring model reads, rounded to bf16
                        model = reranker.model
                        if getattr(reranker, "quantized", False):
                            round_int8_inference(model)
                        amp.enter_context(bf16_params(model))
                pending.append((score(chunk), [(s["qid"], s["posdocid"]) for s in chunk]))
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
        """``ckpt=flat``: ``<path>.params`` (flax msgpack) and ``<path>.optstate``
        (``torch.save``). ``sharded`` / ``sharded_async``: the same trees as
        ``<path>.params.shards`` and ``<path>.optstate.shards`` directories
        (``utils/sharded_ckpt.py``, the JAX format), written on a background
        thread in async mode after a host snapshot. ``<path>.done`` comes
        after both trees (chained on the writer in async mode). Returns the
        bytes of the trees' data.

        On a mesh the optimizer tree is ``_placement_optimizer_tree``'s, and
        a sharded checkpoint writes each sharded leaf as one slab per
        distinct block, never gathered (under pp the canonical tree, as the
        JAX trainer writes it); a flat one writes the canonical tree."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        placement = self._placement
        sharded_params = placement is not None and placement.kind != "pp" and self._ckpt_mode() != "flat"
        if placement is not None and not sharded_params:
            placement.sync_model()
        saveable = self.saveable_params(reranker, model)
        if sharded_params:
            saveable = self._sharded_saveable(saveable)
        if optimizer is None:
            opt_tree = None
        elif placement is not None:
            opt_tree = self._placement_optimizer_tree(optimizer, gather=self._ckpt_mode() == "flat")
        else:
            opt_tree = _optimizer_tree(optimizer.state_dict())
        if self._ckpt_mode() != "flat":
            from capreolus_tpu_torch.utils.sharded_ckpt import AsyncCheckpointer, save_sharded

            ac = None
            if self._ckpt_mode() == "sharded_async":
                if getattr(self, "_async_ckpt", None) is None:
                    self._async_ckpt = AsyncCheckpointer()
                ac = self._async_ckpt
            written = save_sharded(_ext(path, ".params.shards"), saveable, async_checkpointer=ac)
            if opt_tree is not None:
                written += save_sharded(_ext(path, ".optstate.shards"), opt_tree, async_checkpointer=ac)
            done = _ext(path, ".done")
            if ac is not None:  # the done file must cover both trees: chain it on the writer
                ac.after(lambda: done.write_text("done"))
            else:
                done.write_text("done")
            return written
        from capreolus_tpu_torch.utils.flax_msgpack import to_bytes

        params = to_bytes(saveable)
        _ext(path, ".params").write_bytes(params)
        written = len(params)
        if optimizer is not None:
            torch.save(optimizer.state_dict() if placement is None else
                       _tree_map(lambda x: torch.as_tensor(np.array(x)), opt_tree), _ext(path, ".optstate"))
            written += _ext(path, ".optstate").stat().st_size
        _ext(path, ".done").write_text("done")
        return written

    def _sharded_saveable(self, saveable):
        """``saveable``'s tree with each trainable leaf the placement's
        ``ShardedArray`` (frozen leaves stay empty)."""
        store = self._placement.store

        def walk(node, prefix):
            return {k: walk(v, f"{prefix}/{k}") if isinstance(v, dict) else
                    (store[f"{prefix}/{k}"[1:]] if np.asarray(v).size else v) for k, v in node.items()}

        return walk(saveable, "")

    def _placement_optimizer_tree(self, optimizer, gather=False):
        """Adam's state by leaf, whatever the layout: {"state": {store key with
        "." for "/": {"step", "exp_avg", "exp_avg_sq"}}, "param_groups": JSON
        bytes}; each moment a ``ShardedArray`` of the leaf's layout, or with
        ``gather`` the whole moment on the host."""
        from capreolus_tpu_torch.parallel.distributed import ShardedArray

        state = {}
        for key, arr in self._placement.store.items():
            held = [(index, optimizer.state.get(block)) for index, block in arr.blocks.items()]
            if not held or not held[0][1]:
                continue  # frozen, or not stepped yet
            entry = {"step": np.asarray(float(held[0][1]["step"]), np.float32)}
            for m in ("exp_avg", "exp_avg_sq"):
                moment = ShardedArray(arr.sharding, arr.shape, {index: st[m] for index, st in held})
                entry[m] = moment.at("cpu").detach() if gather else moment
            state[key.replace("/", ".")] = entry
        groups = [{k: v for k, v in g.items() if k != "params"} for g in optimizer.state_dict()["param_groups"]]
        return {"state": state, "param_groups": np.frombuffer(json.dumps(groups).encode(), np.uint8)}

    def _by_leaf(self, tree, reranker, model):
        """An optimizer tree (this trainer's on one device, keyed by the
        optimizer's parameter index, or ``_placement_optimizer_tree``'s) as
        {canonical or store key: {"step", "exp_avg", "exp_avg_sq"}} of whole
        flax-layout arrays."""
        from capreolus_tpu_torch.convert import flax_leaves

        state = tree.get("state", {})
        if all(str(k).isdigit() for k in state):
            labels = self.param_labels(reranker, model)
            names = [n for g in ("other", "bert") for n, _ in model.named_parameters() if labels[n] == g]
            layout = {name: (key, to_flax) for key, name, to_flax, _, _ in flax_leaves(model)}
            out = {}
            for i, st in state.items():
                key, to_flax = layout[names[int(i)]]
                out[key] = {k: (np.asarray(v) if k == "step" else to_flax(torch.as_tensor(np.asarray(v))).numpy())
                            for k, v in st.items()}
            return out
        return {k.replace(".", "/"): {m: np.asarray(v) for m, v in st.items()} for k, st in state.items()}

    def _wait_for_checkpoints(self):
        """Join any in-flight asynchronous checkpoint writes (a no-op otherwise)."""
        ac = getattr(self, "_async_ckpt", None)
        if ac is not None:
            ac.wait()

    def load_checkpoint(self, path, model, optimizer, reranker):
        """Restore ``<path>.params`` (either trainer's), or the sharded
        ``<path>.params.shards`` where it exists, into ``model`` through
        ``reranker.state_dict_from_params``, which refills the frozen leaves a
        checkpoint leaves empty with their values (``_merge_frozen``: a frozen
        KNRM's extractor table and kernel bank, Birch's frozen encoder); and
        this trainer's optimizer state into ``optimizer`` when given. Waits
        for in-flight asynchronous writes first. On a mesh every leaf lands on
        the placement's own layout, as the JAX trainer restores onto its
        template's shardings: a sharded directory through ``load_sharded``'s
        ``shardings`` (assembled by global index ranges, whatever layout wrote
        it), and Adam's state by leaf, cut into this layout's blocks."""
        from capreolus_tpu_torch.convert import _present, flatten_tree, flax_leaves, load_params
        from capreolus_tpu_torch.utils.sharded_ckpt import is_sharded_checkpoint, load_sharded

        self._wait_for_checkpoints()
        placement = self._placement
        pdir, odir = _ext(path, ".params.shards"), _ext(path, ".optstate.shards")
        sharded = is_sharded_checkpoint(pdir)
        params = dict(model.named_parameters())
        if sharded and placement is not None and placement.kind != "pp":
            like = self.saveable_params(reranker, model)
            shardings = self._sharded_saveable(like)
            shardings = _tree_map(lambda x: getattr(x, "sharding", None), shardings)
            flat = flatten_tree(load_sharded(pdir, like=like, shardings=shardings))
        else:
            flat = load_params(pdir if sharded else _ext(path, ".params"))
        missing = [key for key, name, *_ in flax_leaves(model)
                   if reranker.trainable(tuple(key.split("/")), params[name]) and not _present(flat, key)]
        if missing:
            raise KeyError(f"checkpoint {path} lacks trainable parameters {missing[:3]}...")
        placed = False
        if placement is not None:
            from capreolus_tpu_torch.parallel.distributed import ShardedArray

            with torch.no_grad():  # a loaded ShardedArray already has this layout's blocks
                for key, v in flat.items():
                    if isinstance(v, ShardedArray):
                        placed = True
                        for index, block in placement.store[key].blocks.items():
                            block.copy_(v.blocks[index])
            flat = {k: (v.numpy() if isinstance(v, ShardedArray) else v) for k, v in flat.items()}
        own = model.state_dict()  # an f32 training model of an int8 reranker has no int8 stats
        try:
            model.load_state_dict({k: v for k, v in reranker.state_dict_from_params(flat, model).items() if k in own})
        except (RuntimeError, ValueError) as e:
            raise RuntimeError(f"checkpoint {path} does not fit the model (a vocabulary-sized table needs the "
                               f"training-time extractor state): {e}") from e
        if placement is not None and not placed:
            placement.load_flat({key: placement.leaves[key][1](params[name].detach())
                                 for key, (name, _, _) in placement.leaves.items()})
        opt_fn = _ext(path, ".optstate")
        if optimizer is None:
            return model, optimizer
        if sharded and is_sharded_checkpoint(odir):
            tree = load_sharded(odir)
        elif opt_fn.exists():
            tree = torch.load(opt_fn, map_location="cpu", weights_only=True)
        else:
            return model, optimizer
        if placement is None and all(str(k).isdigit() for k in tree.get("state", {})):
            # this trainer's own on one device: torch's state dict, or its sharded tree
            optimizer.load_state_dict(tree if isinstance(tree["param_groups"], list) else _optimizer_state_dict(tree))
        else:
            self._load_optimizer_by_leaf(optimizer, self._by_leaf(tree, reranker, model), model)
        return model, optimizer

    def _load_optimizer_by_leaf(self, optimizer, by_leaf, model):
        """Set Adam's state from {key: whole flax-layout moments}: on a mesh
        each block takes its index ranges, on one device each parameter its
        torch layout."""
        from capreolus_tpu_torch.convert import flax_leaves

        def entry(st, cut, device):
            return {"step": torch.tensor(float(st["step"]), dtype=torch.float32),
                    **{m: torch.as_tensor(np.ascontiguousarray(cut(np.asarray(st[m])))).to(device)
                       for m in ("exp_avg", "exp_avg_sq")}}

        placement = self._placement
        if placement is None:
            params = dict(model.named_parameters())
            for key, name, _, from_flax, _ in flax_leaves(model):
                if key in by_leaf:
                    optimizer.state[params[name]] = entry(
                        by_leaf[key], lambda a, f=from_flax: f(torch.as_tensor(a)).contiguous().numpy(),
                        params[name].device)
            return
        for key, arr in placement.store.items():
            if key not in by_leaf:
                continue
            for index, block in arr.blocks.items():
                optimizer.state[block] = entry(by_leaf[key], lambda a, i=index: a[tuple(slice(x, y) for x, y in i)],
                                               block.device)

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
