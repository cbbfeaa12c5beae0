"""The work of the model's operations at their shapes, counted from the
shapes alone (``chip_smoke.py``'s ``k2_bound_ms``, ``k3_bound_ms``,
``x1_bound_ms`` and ``q1_bound_ms``, as functions of shapes): each input byte
read once, each output byte written once, and the operations the function
needs, so that a bound reads the same work whatever implements it.

An op is a dict with a ``kind``:
- ``gemm``: m, k, n, ``dtype`` of the product ("int8", "bf16" or "f32"),
  ``epilogue`` ("int32", "f32", "int8_gelu" for an int8 product; "none"
  otherwise), ``x_scales`` (whether rows carry scales);
- ``attention``: b, h, l, d, ``keys`` (the sum over the batch of the keys a
  row needs: its unmasked keys, all l where every key is masked), ``dtype``;
- ``maxsim``: nq, lq, dim, ``tokens`` (valid doc tokens), ``docs``, ``ld``, ``dtype``;
- ``quantize``: m, k (per-token int8 quantization of f32 rows).

Peaks (``lib/device.py``) charge a product at its declared precision: int8 at
the int8 tensor-core rate, bf16 at bf16's, f32 at TF32's (f32-accurate paths
may run on the tensor cores, as K2's split TF32 does, so no implementation can
read above 100% of the bound); elementwise f32 work at the CUDA cores' f32
rate."""

from __future__ import annotations

ELEM = {"int8": 1, "bf16": 2, "f32": 4}
PRODUCT_PEAK = {"int8": "int8", "bf16": "bf16", "f32": "tf32"}
# f32 operations per output element of an int8 product's epilogue: the
# dequantization's two products and the bias add; for int8-gelu those, 8 of the
# tanh GELU and the division of the requantization
EPILOGUE_OPS = {"int32": 0, "f32": 3, "int8_gelu": 12, "none": 0}
OUT_BYTES = {"int32": 4, "f32": 4, "int8_gelu": 1}


def flops(op):
    """The op's products, counted as two operations per multiply-add (GEMM,
    attention's two products, MaxSim's product); 0 for a quantization."""
    kind = op["kind"]
    if kind == "gemm":
        return 2.0 * op["m"] * op["k"] * op["n"]
    if kind == "attention":
        return 4.0 * op["h"] * op["l"] * op["d"] * op["keys"]
    if kind == "maxsim":
        return 2.0 * op["nq"] * op["lq"] * op["dim"] * op["tokens"]
    return 0.0


def nbytes(op):
    kind = op["kind"]
    if kind == "gemm":
        m, k, n, e = op["m"], op["k"], op["n"], ELEM[op["dtype"]]
        out = OUT_BYTES.get(op["epilogue"], e if op["dtype"] != "int8" else 4)
        vectors = 0.0
        if op["epilogue"] in ("f32", "int8_gelu"):
            vectors = (4.0 * m if op.get("x_scales", True) else 0.0) + 8.0 * n + (4.0 * n if op["epilogue"] == "int8_gelu" else 0.0)
        return e * (m * k + n * k) + out * m * n + vectors
    if kind == "attention":
        b, h, l, d, e = op["b"], op["h"], op["l"], op["d"], ELEM[op["dtype"]]
        return 2.0 * b * h * l * d * e + 2.0 * h * d * e * op["keys"] + b * l
    if kind == "maxsim":
        e = ELEM[op["dtype"]]
        return (e * op["nq"] * op["lq"] * op["dim"] + e * op["tokens"] * op["dim"] + 4.0 * op["ld"] * op["docs"]
                + op["docs"] + 4.0 * op["nq"] * op["docs"])
    if kind == "quantize":
        return 5.0 * op["m"] * op["k"] + 4.0 * op["m"]
    raise ValueError(f"unknown op kind {kind!r}")


def least_seconds(op, peaks):
    """The least time the card could take for ``op``: the larger of its bytes
    over the HBM rate and its operations over the peak that charges them."""
    t_bytes = nbytes(op) / peaks["bw"]
    kind = op["kind"]
    if kind == "quantize":
        t_ops = 4.0 * op["m"] * op["k"] / peaks["f32"]
    else:
        t_ops = flops(op) / peaks[PRODUCT_PEAK[op["dtype"]]]
        if kind == "gemm":
            t_ops = max(t_ops, EPILOGUE_OPS[op["epilogue"]] * op["m"] * op["n"] / peaks["f32"])
    return max(t_bytes, t_ops)


def product_seconds(op, peaks):
    """The op's products alone at the peak of their precision (what ``mfu`` counts)."""
    if op["kind"] == "quantize":
        return 0.0
    return flops(op) / peaks[PRODUCT_PEAK[op["dtype"]]]


def bert_encoder_ops(model, b, l, quantize, keys=None):
    """The ops of one BERT encoder forward over [b, l] tokens: per layer the
    q, k, v and output projections, attention and the two FFN products; with
    ``quantize`` "int8" each product is int8 (f32 epilogue, the up-projection
    int8-gelu, the down-projection's row scales folded into the weight) and
    three per-token quantizations per layer; else f32 products. ``keys``:
    the batch's needed keys (b * l where every key counts)."""
    h, inter, heads = model["hidden_size"], model["intermediate_size"], model["num_attention_heads"]
    m = b * l
    keys = b * l if keys is None else keys
    ops = []
    for _ in range(model["num_hidden_layers"]):
        if quantize == "int8":
            ops += [{"kind": "quantize", "m": m, "k": h}] * 3
            ops += [{"kind": "gemm", "m": m, "k": h, "n": h, "dtype": "int8", "epilogue": "f32"}] * 4
            ops += [{"kind": "gemm", "m": m, "k": h, "n": inter, "dtype": "int8", "epilogue": "int8_gelu"},
                    {"kind": "gemm", "m": m, "k": inter, "n": h, "dtype": "int8", "epilogue": "f32", "x_scales": False}]
        else:
            ops += [{"kind": "gemm", "m": m, "k": h, "n": h, "dtype": "f32", "epilogue": "none"}] * 4
            ops += [{"kind": "gemm", "m": m, "k": h, "n": inter, "dtype": "f32", "epilogue": "none"},
                    {"kind": "gemm", "m": m, "k": inter, "n": h, "dtype": "f32", "epilogue": "none"}]
        ops.append({"kind": "attention", "b": b, "h": heads, "l": l, "d": h // heads, "keys": keys, "dtype": "f32"})
    return ops
