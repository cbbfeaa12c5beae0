"""The operation and byte counts, bounds and trace reductions on shapes counted by hand."""

import json

import pytest

from lib import device, work
from lib.trace import Trace, short

H100 = device.peaks_of("NVIDIA H100 80GB HBM3")


def test_peaks_of_the_h100_family():
    assert H100 == {"bw": 3.35e12, "f32": 67e12, "bf16": 989e12, "int8": 1979e12, "tf32": 495e12}
    assert device.peaks_of("NVIDIA H100 PCIe")["bw"] == 2.0e12
    with pytest.raises(KeyError):
        device.peaks_of("NVIDIA A100-SXM4-80GB")


def test_an_int8_gemm_with_the_f32_epilogue():
    op = {"kind": "gemm", "m": 4, "k": 3, "n": 2, "dtype": "int8", "epilogue": "f32"}
    assert work.flops(op) == 2 * 4 * 3 * 2
    # codes 4*3 + 2*3 bytes, f32 out 4*4*2, x_scales 4*4, w_scales and bias 8*2
    assert work.nbytes(op) == 12 + 6 + 32 + 16 + 16
    assert work.nbytes(dict(op, x_scales=False)) == 12 + 6 + 32 + 16
    gelu = dict(op, epilogue="int8_gelu")
    assert work.nbytes(gelu) == 12 + 6 + 8 + 16 + 16 + 8


def test_a_bound_is_the_larger_of_bytes_and_operations():
    big = {"kind": "gemm", "m": 409600, "k": 768, "n": 3072, "dtype": "int8", "epilogue": "int8_gelu"}
    t_bytes = work.nbytes(big) / H100["bw"]
    t_ops = max(2.0 * 409600 * 768 * 3072 / H100["int8"], 12.0 * 409600 * 3072 / H100["f32"])
    assert work.least_seconds(big, H100) == max(t_bytes, t_ops)
    assert abs(work.least_seconds(big, H100) * 1e3 - 0.9766) < 1e-3  # PERF.md's int8-gelu bound at this shape
    f32 = {"kind": "gemm", "m": 10, "k": 10, "n": 10, "dtype": "f32", "epilogue": "none"}
    assert work.product_seconds(f32, H100) == 2000 / 495e12


def test_attention_counts_the_keys_a_row_needs():
    op = {"kind": "attention", "b": 2, "h": 3, "l": 5, "d": 4, "keys": 7, "dtype": "f32"}
    assert work.flops(op) == 4 * 3 * 5 * 4 * 7
    assert work.nbytes(op) == 2 * 2 * 3 * 5 * 4 * 4 + 2 * 3 * 4 * 4 * 7 + 2 * 5


def test_maxsim_and_quantize():
    op = {"kind": "maxsim", "nq": 2, "lq": 3, "dim": 4, "tokens": 10, "docs": 5, "ld": 6, "dtype": "bf16"}
    assert work.flops(op) == 2 * 2 * 3 * 4 * 10
    assert work.nbytes(op) == 2 * 24 + 2 * 40 + 4 * 30 + 5 + 4 * 10
    q = {"kind": "quantize", "m": 3, "k": 8}
    assert work.flops(q) == 0 and work.nbytes(q) == 5 * 24 + 12
    assert work.least_seconds(q, H100) == max(132 / H100["bw"], 96 / H100["f32"])


def test_bert_encoder_ops_per_layer():
    model = {"hidden_size": 768, "intermediate_size": 3072, "num_attention_heads": 12, "num_hidden_layers": 12}
    ops = work.bert_encoder_ops(model, 1600, 256, "int8", keys=1000)
    kinds = [op["kind"] for op in ops]
    assert kinds.count("quantize") == 36 and kinds.count("attention") == 12
    gemms = [op for op in ops if op["kind"] == "gemm"]
    assert len(gemms) == 72 and sum(op["epilogue"] == "int8_gelu" for op in gemms) == 12
    linear = sum(work.flops(op) for op in gemms)
    assert linear == 12 * 2 * 409600 * (4 * 768 * 768 + 2 * 768 * 3072)
    f32 = work.bert_encoder_ops(model, 2, 32, "none")
    assert all(op["dtype"] == "f32" for op in f32) and f32[-1]["keys"] == 64


def test_mfu_leaves_out_an_implementations_own_product():
    from lib import registry

    mfu = registry.load_module("metrics", "mfu")

    class Run:
        peaks, window_s = H100, 1.0
        ops = [{"kind": "gemm", "m": 1000, "k": 1000, "n": 1000, "dtype": "bf16", "epilogue": "none"},
               {"kind": "gemm", "m": 1000, "k": 1000, "n": 1000, "dtype": "int8", "epilogue": "int32", "mfu": False}]

    assert mfu.read(Run) == pytest.approx(100 * 2e9 / 989e12)


def chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.from_chrome(path)


def x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_time_is_the_union_inside_the_window(tmp_path):
    tr = chrome(tmp_path, [
        x("user_annotation", "gpubench.window", 100, 100),
        x("kernel", "void (anonymous namespace)::int8_gemm_kernel<128, 1>(CUtensorMap, Params)", 90, 30),
        x("kernel", "attention_kernel<float, 64>", 110, 20),  # overlaps the first
        x("gpu_memcpy", "Memcpy DtoH", 150, 10),
        x("kernel", "late", 195, 20),  # cut at the window's end
        x("user_annotation", "gpubench.collect", 160, 35),
        x("cpu_op", "aten::copy_", 130, 15),
    ])
    assert tr.window_s == 100e-6
    assert tr.busy_s == pytest.approx((130 - 100 + 10 + 5) * 1e-6)
    assert tr.device_seconds(lambda n: "int8_gemm_kernel" in n) == (30e-6, 1)
    assert tr.top_device_ops()[0] == ["int8_gemm_kernel<128, 1>", pytest.approx(30e-6)]
    idle = dict(tr.idle_by_host())
    assert idle["host: aten::copy_"] == pytest.approx(20e-6)  # 130-150
    assert idle["host: gpubench.collect"] == pytest.approx(35e-6)  # 160-195
    assert short("void at::native::(anonymous namespace)::foo<1>(int)") == "at::native::foo<1>"
