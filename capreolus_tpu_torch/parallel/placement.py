"""A model's parameters placed on a mesh for training (the layouts of the
JAX trainer's ``_place_params`` and ``_pp_setup``).

``Placement(model, mesh, kind)`` keeps every parameter leaf of ``model`` in
the JAX package's flax layout, keyed by its flax path, as a ``ShardedArray``
with the spec the JAX trainer gives it:

- ``dp``: replicated (one block on the first device, copied to each data
  shard's device at use: the broadcast);
- ``fsdp``: ``fsdp.fsdp_param_spec`` over ``data`` (gathered at use);
- ``tp``: ``tensor_parallel.tp_spec`` over ``model``; each ``BertEncoder``
  runs through ``tensor_parallel.tp_encoder`` (with ``sp``, token-split);
- ``ep``: ``expert_parallel.ep_spec`` over ``expert``; each ``MoeFFN`` runs
  through ``expert_parallel.ep_moe``;
- ``pp``: the encoder's layers stacked (``stacked/<suffix>`` keys) and split
  over ``pipe`` (over ``model`` too on a 3D mesh); the encoder runs through
  ``pipeline_parallel.gpipe``.

The blocks are the leaf tensors an optimizer steps. ``bind()`` makes the
model compute from them: each module that owns parameters (outside the
encoders and expert FFNs that run through the functions above) reads them,
at each call, as the store's values on the device of the call's first
tensor argument, and the module's own parameters come back after the call.
The root module's own parameters read as their values on the first device
for the whole block, for the methods a reranker calls outside ``forward``.
A data shard is found by its first device: a device list names each device
once, or one device throughout.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from capreolus_tpu_torch.parallel.distributed import Mesh, NamedSharding, P, ShardedArray

KINDS = ("dp", "fsdp", "tp", "ep", "pp")


def _first_tensor(args, kwargs):
    for value in list(args) + list(kwargs.values()):
        if torch.is_tensor(value):
            return value
    return None


class Placement:
    def __init__(self, model, mesh: Mesh, kind, trainable=None, sp=False, amp=False, microbatches=0):
        from capreolus_tpu_torch.convert import flax_leaves
        from capreolus_tpu_torch.reranker.bert.encoder import BertEncoder, MoeFFN

        if kind not in KINDS:
            raise ValueError(f"unknown placement {kind!r}")
        self.model, self.mesh, self.kind, self.sp, self.amp = model, mesh, kind, bool(sp), bool(amp)
        self.microbatches = int(microbatches or 0)
        self.leaves = {key: (name, to_flax, from_flax) for key, name, to_flax, from_flax, _ in flax_leaves(model)}
        self._keys = {name: key for key, (name, _, _) in self.leaves.items()}
        self.params = dict(model.named_parameters())
        self.encoders = {m: mod for m, mod in model.named_modules() if isinstance(mod, BertEncoder)}
        self.moes = {m: mod for m, mod in model.named_modules() if isinstance(mod, MoeFFN)}
        trainable = set(self.leaves) if trainable is None else set(trainable)
        flat = {key: to_flax(self.params[name].detach()) for key, (name, to_flax, _) in self.leaves.items()}
        self.store = self._place(flat)
        for key, arr in self.store.items():
            grad = key in trainable if key in self.leaves else all(k in trainable for k in self.stacked_from(key))
            for block in arr.blocks.values():
                block.requires_grad_(grad)

    # ------------------------------------------------------------------ layout
    @property
    def dp(self):
        return self.mesh.shape["data"]

    def lead(self, r):
        """Data shard r's first device."""
        return self.mesh.devices[r].flat[0] if self.mesh.devices.ndim > 1 else self.mesh.devices[r]

    def shard_of(self, device):
        """The data shard whose first device is ``device``."""
        from capreolus_tpu_torch.parallel.distributed import normalize_device

        device = normalize_device(device)
        for r in range(self.dp):
            if normalize_device(self.lead(r)) == device:
                return r
        raise ValueError(f"{device} is no data shard's first device in {self.mesh}")

    def _prefix(self, mname):
        return "/".join(["params"] + (mname.split(".") if mname else []))

    def _pp_encoder(self):
        """(module name, encoder) of the encoder the pipeline runs."""
        if len(self.encoders) != 1:
            raise ValueError(f"pipeline parallelism needs one BERT encoder; the model has {len(self.encoders)}")
        return next(iter(self.encoders.items()))

    def stacked_key(self, key):
        """(stacked key, layer) of a pipelined layer's canonical key, else None."""
        mname, _ = self._pp_encoder()
        head = self._prefix(mname) + "/layer_"
        if not key.startswith(head):
            return None
        layer, suffix = key[len(head):].split("/", 1)
        return f"stacked/{suffix}", int(layer)

    def stacked_from(self, key):
        """The canonical keys a stacked key holds, layer by layer."""
        mname, enc = self._pp_encoder()
        suffix = key[len("stacked/"):]
        return [f"{self._prefix(mname)}/layer_{i}/{suffix}" for i in range(enc.config.num_layers)]

    def _num_heads(self):
        heads = {enc.config.num_heads for enc in self.encoders.values()}
        return heads.pop() if len(heads) == 1 else None

    def _place(self, flat):
        mesh = self.mesh
        if self.kind == "fsdp":
            from capreolus_tpu_torch.parallel.fsdp import shard_params_fsdp

            return shard_params_fsdp(flat, mesh)
        if self.kind == "tp":
            from capreolus_tpu_torch.parallel.tensor_parallel import shard_params_tp

            return shard_params_tp(flat, mesh, self._num_heads())
        if self.kind == "ep":
            from capreolus_tpu_torch.parallel.expert_parallel import shard_params_ep

            return shard_params_ep(flat, mesh)
        rep = NamedSharding(mesh, P())
        if self.kind == "dp":
            return {key: ShardedArray.from_tensor(v, rep) for key, v in flat.items()}
        from capreolus_tpu_torch.parallel import pipeline_parallel as ppmod

        mname, enc = self._pp_encoder()
        layers = {}
        rest = {}
        for key, v in flat.items():
            sk = self.stacked_key(key)
            if sk is None:
                rest[key] = ShardedArray.from_tensor(v, rep)
            else:
                layers.setdefault(sk[0], [None] * enc.config.num_layers)[sk[1]] = v
        for skey, values in layers.items():
            stacked = torch.stack(values)
            spec = ppmod.stacked_spec(skey, tuple(stacked.shape), mesh, enc.config.num_heads)
            rest[skey] = ShardedArray.from_tensor(stacked, NamedSharding(mesh, spec))
        return rest

    # ------------------------------------------------------------------ values
    def _amp(self, key, x, native=False):
        """Under amp, the bf16 rounding of an f32 leaf (widened back unless ``native``)."""
        if not self.amp or x.dtype != torch.float32:
            return x
        r = x.to(torch.bfloat16)
        return r if native else r.float()

    def torch_value(self, key, device, native=False):
        """Leaf ``key`` gathered on ``device`` in its parameter's torch layout,
        amp-rounded (a module's own leaf: never a pipelined layer's)."""
        return self._amp(key, self.leaves[key][2](self.store[key].at(device)), native)

    @torch.no_grad()
    def sync_model(self):
        """Write the store's values into the model's own parameters (the
        canonical tree), each store leaf gathered once."""
        device = next(iter(self.params.values())).device
        for skey, arr in self.store.items():
            full = arr.at(device)
            keys = self.stacked_from(skey) if skey.startswith("stacked/") else [skey]
            for i, key in enumerate(keys):
                name, _, from_flax = self.leaves[key]
                value = full[i] if skey.startswith("stacked/") else full
                self.params[name].copy_(from_flax(value).to(self.params[name].dtype))

    @torch.no_grad()
    def load_flat(self, flat):
        """Set the store from {canonical key: global array} (a checkpoint's leaves)."""
        values = {}
        for key, v in flat.items():
            if key not in self.leaves:
                continue
            sk = self.stacked_key(key) if self.kind == "pp" else None
            if sk is None:
                values[key] = torch.as_tensor(v)
            else:
                values.setdefault(sk[0], {})[sk[1]] = torch.as_tensor(v)
        for skey, layers in list(values.items()):
            if isinstance(layers, dict):
                values[skey] = torch.stack([layers[i] for i in range(len(layers))])
        for skey, v in values.items():
            arr = self.store[skey]
            for index, block in arr.blocks.items():
                block.copy_(v[tuple(slice(a, b) for a, b in index)].to(block.dtype))

    # ------------------------------------------------------------------ binding
    def _getter_layer(self, mname, r):
        """get(i, suffix, j) of encoder ``mname``'s layer leaves for data shard r (tp)."""
        pfx = self._prefix(mname)
        cache = {}

        def get(i, suffix, j):
            key = f"{pfx}/layer_{i}/{suffix}"
            if (key, j) not in cache:
                cache[(key, j)] = self._amp(key, self.store[key].block((r, j)))
            return cache[(key, j)]

        return get

    def _getter_rest(self, mname, native_names):
        """get(name, device) of encoder ``mname``'s own leaves (embeddings, pooler)."""
        pfx = self._prefix(mname)

        def get(name, device):
            key = f"{pfx}/{name}"
            return self._amp(key, self.store[key].at(device), name in native_names)

        return get

    def _encoder_forward(self, mname, encoder, input_ids, attention_mask, token_type_ids, calibrate=False,
                         dropout_seed=None, output_hidden_states=False):
        from capreolus_tpu_torch.parallel import pipeline_parallel as ppmod
        from capreolus_tpu_torch.parallel import tensor_parallel as tpmod
        from capreolus_tpu_torch.reranker.bert.encoder import dropout

        if calibrate:
            raise ValueError("int8 calibration runs on the canonical model, not on a mesh placement")
        c = encoder.config
        r = self.shard_of(input_ids.device)
        get_rest = self._getter_rest(mname, encoder.amp_bf16_params)
        if self.kind == "tp":
            devices = list(self.mesh.devices[r])
            return tpmod.tp_encoder(c, get_rest, self._getter_layer(mname, r), input_ids, attention_mask,
                                    token_type_ids, devices, dropout_seed, self.sp, output_hidden_states,
                                    remat=c.remat)
        # pp: embeddings on the shard's first device, the stack through the schedule, the pooler
        lead = input_ids.device
        hidden = dropout(tpmod.embed(c, get_rest, input_ids, token_type_ids, lead), c.hidden_dropout_prob,
                         dropout_seed, 0)
        stacked = {key[len("stacked/"):]: arr for key, arr in self.store.items() if key.startswith("stacked/")}
        layer = ppmod.stage_layer_fn(c, stacked, self.mesh, r, lambda suffix, x: self._amp(suffix, x))
        if output_hidden_states:
            raise ValueError("the pipeline returns the last layer's output only")
        seq = ppmod.gpipe(c, ppmod.stage_devices_of(self.mesh, r), layer, hidden, attention_mask.bool(),
                          self.microbatches, dropout_seed)
        return seq, tpmod.pool(c, get_rest, seq)

    def _moe_forward(self, mname, x):
        from capreolus_tpu_torch.parallel.expert_parallel import ep_moe

        pfx = self._prefix(mname)
        r = self.shard_of(x.device)
        moe = self.moes[mname]

        def get(name, j):
            key = f"{pfx}/{name}"
            return self._amp(key, self.store[key].block((r, j)))

        return ep_moe(moe.config, get, x, list(self.mesh.devices[r]))

    @contextlib.contextmanager
    def bind(self):
        """Within the block the model computes from the store (module docstring)."""
        model = self.model
        overridden = {}
        if self.kind in ("tp", "pp"):
            overridden = {m: functools.partial(self._encoder_forward, m, enc) for m, enc in self.encoders.items()}
        elif self.kind == "ep":
            overridden = {m: functools.partial(self._moe_forward, m) for m in self.moes}
        handles, swapped = [], []
        modules = dict(model.named_modules())

        def inside(name):
            return any(name == m or name.startswith(m + ".") if m else True for m in overridden)

        def swap_in(module, names, device):
            native = getattr(module, "amp_bf16_params", ())
            old = {}
            for pname, key in names:
                old[pname] = module._parameters[pname]
                module._parameters[pname] = self.torch_value(key, device, pname in native)
            return old

        try:
            for m, fwd in overridden.items():
                modules[m].forward = fwd
            lead0 = self.lead(0)
            for mname, module in modules.items():
                if overridden and inside(mname):
                    continue
                names = [(pname, self._keys[f"{mname}.{pname}" if mname else pname])
                         for pname, p in module._parameters.items() if p is not None]
                if not names:
                    continue
                if mname == "":
                    swapped.append((module, swap_in(module, names, lead0)))
                stack = []

                def pre(mod, args, kwargs, names=names, stack=stack):
                    x = _first_tensor(args, kwargs)
                    stack.append(swap_in(mod, names, x.device if x is not None else lead0))

                def post(mod, args, kwargs, output, stack=stack):
                    for pname, value in stack.pop().items():
                        mod._parameters[pname] = value

                handles.append(module.register_forward_pre_hook(pre, with_kwargs=True))
                handles.append(module.register_forward_hook(post, with_kwargs=True, always_call=True))
            yield self
        finally:
            for h in handles:
                h.remove()
            for module, old in swapped:
                for pname, value in old.items():
                    module._parameters[pname] = value
            for m in overridden:
                modules[m].__dict__.pop("forward", None)

    # ------------------------------------------------------------------ data
    def split(self, batch):
        """[(data shard r's first device, its rows)] of a dict of numpy arrays."""
        n = next(iter(batch.values())).shape[0]
        if n % self.dp:
            raise ValueError(f"batch {n} does not divide over data={self.dp}")
        rows = n // self.dp
        return [(self.lead(r), {k: v[r * rows:(r + 1) * rows] for k, v in batch.items()}) for r in range(self.dp)]
