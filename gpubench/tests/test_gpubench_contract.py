"""BENCHMARK.json keeps the benchmark's contract, every part of a cell is
found by name, and a run refuses what it must refuse."""

import json
import re
import subprocess
import sys

import pytest

from lib import nojax, registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|_dim$|_rank$|expansion|experts_per)")


def test_keys_names_units_and_texts(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["gpubench"] and bench["command"][1] == "gpubench/run.py"
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
        assert c["file"].startswith("gpubench/configs/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic")) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_finds_its_parts_and_reports_enough(bench):
    by_config = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        config = registry.load_json("configs", w["config"])
        assert config["name"] == w["config"] and set(by_config[w["config"]]["reduced"]) == set(config["reduced"])
        mix = registry.load_json("traffic", w["traffic"])
        assert callable(registry.load_module("loops", mix["loop"]).run)
        registry.load_module("systems", config["system"])
        ref = registry.load_module("reference", config["name"])
        assert callable(ref.check) and ref.CONTROLS and config["limits"]
        assert all(callable(fn) for fn in ref.CONTROLS.values())
        e2e = [m["name"] for m in registry.metrics_of(bench, w["name"], 0)]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = registry.metrics_of(bench, w["name"], 1)
        assert per_layer
        for m in registry.metrics_of(bench, w["name"], 0) + per_layer:
            assert callable(registry.load_module("metrics", m["name"]).read)


def test_run_seconds_fit_the_check_with_24_cells(bench):
    runs = 2 + 14 * 24
    assert 1 <= bench["run_seconds"] <= 51
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind,name,body", [
    ("configs", "newconfig", json.dumps({"name": "newconfig", "system": "maxp_rerank"})),
    ("traffic", "newmix", json.dumps({"loop": "closed", "in_flight": 3})),
    ("metrics", "new_metric", "def read(run):\n    return 42.0\n"),
    ("loops", "newloop", "def run(system, mix, seconds, span=None):\n    return [], 42.0\n"),
])
def test_a_new_part_is_found_by_its_name_alone(tmp_path, kind, name, body):
    (tmp_path / kind).mkdir()
    (tmp_path / kind / f"{name}.{'py' if kind in ('metrics', 'loops') else 'json'}").write_text(body)
    if kind == "metrics":
        assert registry.load_module(kind, name, base=tmp_path).read(None) == 42.0
    elif kind == "loops":
        assert registry.load_module(kind, name, base=tmp_path).run(None, {}, 1.0) == ([], 42.0)
    else:
        assert registry.load_json(kind, name, base=tmp_path) == json.loads(body)


def test_a_metric_without_workloads_counts_for_every_cell_reporting_what_it_moves():
    bench = {"end_to_end": [{"name": "setup_s"}, {"name": "queries_per_s", "workloads": ["a"]}],
             "per_layer": [{"name": "x", "moves": "queries_per_s"}, {"name": "y", "moves": "queries_per_s",
                                                                     "workloads": ["b"]}]}
    assert [m["name"] for m in registry.metrics_of(bench, "a", 1)] == ["x"]
    assert [m["name"] for m in registry.metrics_of(bench, "b", 1)] == []
    assert [m["name"] for m in registry.metrics_of(bench, "b", 0)] == ["setup_s"]


@pytest.mark.parametrize("modules,found", [
    (["capreolus_tpu_torch", "capreolus_tpu_torch.ops.maxsim", "numpy", "torch"], []),
    (["capreolus_tpu", "capreolus_tpu_torch"], ["capreolus_tpu"]),
    (["capreolus_tpu.serving"], ["capreolus_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen", "jaxtyping", "flaxy"], ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_are_compared_by_whole_top_level_names(modules, found):
    assert nojax.forbidden_modules(modules) == found


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = ['gpubench', '.']; import run, control; "
            "from lib import trace, work, readers; import systems.colbert_retrieval; "
            "from lib import nojax; print(nojax.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=registry.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "maxp-int8-rerank", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=registry.ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "card" in out.stderr
