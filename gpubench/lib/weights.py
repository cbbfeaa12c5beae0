"""Seeded BERT-base weights, made on the device in a few large calls: every
matrix and embedding table N(0, ``std``) from one ``torch.Generator`` on the
device, biases 0, LayerNorm scales 1 (``chip_smoke.py``'s
``seeded_bert_params`` rule). The leaves have names of the benchmark's own
(``bert_leaves``), in torch's [out, in] layout; a system maps them onto the
program's parameter names, and the reference reads them as they are, so both
sides get the same values from the same seed."""

from __future__ import annotations

import numpy as np
import torch


def torch_seed(seed, stream):
    """A 63-bit seed for ``torch.Generator.manual_seed`` from (seed, stream)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *(ord(c) for c in stream)])
    return int(ss.generate_state(2, np.uint32).astype(np.uint64) @ np.array([1, 2 ** 32], np.uint64)) >> 1


def bert_leaves(model, head):
    """[(name, shape, init)] of a BERT encoder of ``model`` (the configuration's
    widths) with ``head``: "classifier" (a 1-output relevance head) or
    "colbert" (a bias-free [dim, hidden] projection). init is "normal",
    "zeros" or "ones"."""
    h, inter = model["hidden_size"], model["intermediate_size"]
    out = [("emb.word", (model["vocab_size"], h), "normal"),
           ("emb.position", (model["max_position_embeddings"], h), "normal"),
           ("emb.type", (model["type_vocab_size"], h), "normal"),
           ("emb.ln.scale", (h,), "ones"), ("emb.ln.bias", (h,), "zeros")]
    for i in range(model["num_hidden_layers"]):
        p = f"layer{i}."
        for name in ("q", "k", "v", "o"):
            out += [(p + name + ".w", (h, h), "normal"), (p + name + ".b", (h,), "zeros")]
        out += [(p + "attn_ln.scale", (h,), "ones"), (p + "attn_ln.bias", (h,), "zeros"),
                (p + "ffn_in.w", (inter, h), "normal"), (p + "ffn_in.b", (inter,), "zeros"),
                (p + "ffn_out.w", (h, inter), "normal"), (p + "ffn_out.b", (h,), "zeros"),
                (p + "out_ln.scale", (h,), "ones"), (p + "out_ln.bias", (h,), "zeros")]
    if head == "classifier":
        out += [("pooler.w", (h, h), "normal"), ("pooler.b", (h,), "zeros"),
                ("classifier.w", (1, h), "normal"), ("classifier.b", (1,), "zeros")]
    elif head == "colbert":
        out += [("pooler.w", (h, h), "normal"), ("pooler.b", (h,), "zeros"),
                ("linear.w", (model["dim"], h), "normal")]
    else:
        raise ValueError(f"unknown head {head!r}")
    return out


def seeded_weights(leaves, seed, device, std=0.02):
    """{name: f32 tensor on ``device``}: one randn call for every normal leaf."""
    sizes = [int(np.prod(shape)) for _, shape, init in leaves if init == "normal"]
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, "weights"))
    flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(std)
    out, pos = {}, 0
    for name, shape, init in leaves:
        if init == "normal":
            n = int(np.prod(shape))
            out[name] = flat[pos:pos + n].view(shape)
            pos += n
        else:
            out[name] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return out
