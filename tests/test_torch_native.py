"""The port's native C++ host helpers (``capreolus_tpu_torch/native``) against
the JAX package's, on the CPU.

The three libraries must build here (g++ is on this host): a library that
does not build fails these tests, never skips them. The port's native
analyzer equals the JAX package's native analyzer and the port's Python
chain; its Porter stems, TREC parses and krovetz stems equal the JAX
package's; with ``CAPREOLUS_NATIVE=0`` or without g++ every caller falls
back and ``native_status()`` says why; two processes building one library
at once both load it.
"""

import gzip
import json
import logging
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import capreolus_tpu_torch.native as native
from capreolus_tpu.analysis.analyzer import EnglishAnalyzer as JaxEnglishAnalyzer
from capreolus_tpu.analysis.kstem import kstem as jax_kstem
from capreolus_tpu.analysis.porter import porter_stem as jax_porter_stem
from capreolus_tpu_torch.analysis import EnglishAnalyzer, porter_stem
from capreolus_tpu_torch.analysis.kstem import kstem
from capreolus_tpu_torch.utils.trec import TREC_CONTENT_TAGS, iterate_trec_docs

ROOT = Path(__file__).resolve().parent.parent

# tests/test_native.py's texts
TEXTS = [
    "The quick brown fox jumps over the lazy dog's back!",
    "it's a 3.14 U.S.A test with 1,000 items",
    "Nationalization proceedings energized traditional RELATIONAL databases.",
    "foo-bar baz_qux x86 processors; O'Brien's 2nd attempt...",
    "",
    "a the of",
    "hello",
]
FUZZ_POOLS = ["abcdefgh ", "THE and of ", "a.b,c'd-e ", "\t\n\x01 ", "123a456 ", "o'brien's ", "-x_y-- ",
              "U.S.A. 3.14 ", "running cities hopped "]
FUZZ_SEEDS = 8  # each a case of 50 random ASCII texts


def fuzz_texts(seed, n=50):
    rng = random.Random(seed)
    return ["".join(rng.choice(FUZZ_POOLS)[rng.randrange(0, 3):] for _ in range(rng.randrange(1, 12)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module, its libraries built into a directory of
    this module's own (its loader compiles in place under its cache path, which
    another test process may be writing at the same moment)."""
    import capreolus_tpu.native as jn
    from capreolus_tpu.core import constants as jax_constants

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_constants, "CACHE_BASE_PATH", tmp_path_factory.mktemp("jax_native"))
        mp.delenv("CAPREOLUS_NATIVE", raising=False)
        for lib, tried in (("_LIB", "_TRIED"), ("_TREC_LIB", "_TREC_TRIED"), ("_PRUNER_LIB", "_PRUNER_TRIED")):
            mp.setattr(jn, lib, None)
            mp.setattr(jn, tried, False)
        assert jn.get_analyzer_lib() is not None and jn.get_trec_reader_lib() is not None
        assert jn.get_pruner_lib() is not None
        yield jn


def test_every_library_builds_and_loads_here(monkeypatch):
    monkeypatch.delenv("CAPREOLUS_NATIVE", raising=False)
    status = native.native_status()
    assert sorted(status) == sorted(native.LIBRARIES)
    for name, st in status.items():
        assert st["loaded"], (name, st)
        assert Path(st["path"]).parent == native.BUILD_DIR and Path(st["path"]).exists()
        assert Path(st["path"]) == native.library_path(name)
    assert native.get_analyzer_lib() is not None and native.get_pruner_lib() is not None
    # the port's sources are the JAX package's, but for one comment line of pruner.cpp
    for name in ("analyzer", "trec_reader"):
        assert (ROOT / "capreolus_tpu_torch" / "native" / f"{name}.cpp").read_bytes() == \
            (ROOT / "capreolus_tpu" / "native" / f"{name}.cpp").read_bytes()
    ours = (ROOT / "capreolus_tpu_torch" / "native" / "pruner.cpp").read_text().splitlines()
    ref = (ROOT / "capreolus_tpu" / "native" / "pruner.cpp").read_text().splitlines()
    assert len(ours) == len(ref) and sum(a != b for a, b in zip(ours, ref)) == 1
    assert all(a == b or a.startswith("//") for a, b in zip(ours, ref))


@pytest.mark.parametrize("use_porter", [True, False])
@pytest.mark.parametrize("keep_stops", [True, False])
@pytest.mark.parametrize("case", [f"text{i}" for i in range(len(TEXTS))] + [f"fuzz{s}" for s in range(FUZZ_SEEDS)])
def test_native_analyzer_equals_jax_native_and_the_python_chain(jax_native, monkeypatch, case, use_porter,
                                                                keep_stops):
    texts = [TEXTS[int(case[4:])]] if case.startswith("text") else fuzz_texts(int(case[4:]))
    stemmer = "porter" if use_porter else "none"
    monkeypatch.delenv("CAPREOLUS_NATIVE", raising=False)
    ours = [native.native_analyze(t, use_porter, keep_stops) for t in texts]
    through_analyzer = [EnglishAnalyzer(stemmer, keep_stops).analyze(t) for t in texts]
    ref = [jax_native.native_analyze(t, use_porter, keep_stops) for t in texts]
    monkeypatch.setenv("CAPREOLUS_NATIVE", "0")
    assert native.native_analyze(texts[0], use_porter, keep_stops) is None
    python = [EnglishAnalyzer(stemmer, keep_stops).analyze(t) for t in texts]
    assert ours == ref == python == through_analyzer
    assert python == [JaxEnglishAnalyzer(stemmer, keep_stops).analyze(t) for t in texts]


def test_native_porter_vectors(jax_native):
    rng = np.random.Generator(np.random.PCG64(0))
    words = ("caresses ponies ties cats feed agreed plastered motoring sing conflated sized hopping "
             "falling hissing failing filing happy sky relational conditional rational hesitanci "
             "digitizer differentli vileli analogousli vietnamization predication operator feudalism "
             "decisiveness hopefulness formaliti sensitiviti sensibiliti triplicate formative formalize "
             "electriciti hopeful goodness revival allowance inference airliner gyroscopic adjustable "
             "defensible irritant replacement adjustment dependent adoption communism activate "
             "angulariti homologous effective bowdlerize probate rate cease controll roll archaeology").split()
    for _ in range(300):
        words.append("".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(rng.integers(1, 12)))))
    for w in words:
        assert native.native_porter_stem(w) == jax_native.native_porter_stem(w) == porter_stem(w) \
            == jax_porter_stem(w), w


def _trec_blocks(rng, n):
    words = "alpha beta gamma delta epsilon zeta Running CITIES".split()
    blocks = []
    for i in range(n):
        text = " ".join(rng.choice(words, size=int(rng.integers(3, 30))))
        head = " ".join(rng.choice(words, size=3))
        blocks.append(f"<DOC>\n<DOCNO> NT{i:03d} </DOCNO>\n<SECTION>\n<P>\nignored section\n</P>\n</SECTION>\n"
                      f"<HEADLINE>\n<P>\n{head}\n</P>\n</HEADLINE>\n<DATE> 1994 </DATE>\n"
                      f"<TEXT>\n<P>\n{text}\n</P>\n{text[:7]}\n</TEXT>\n</DOC>\n")
    return "".join(blocks)


def test_native_trec_reader_equals_jax_and_the_python_parser(jax_native, monkeypatch, tmp_path):
    from capreolus_tpu.utils.trec import iterate_trec_docs as jax_iterate_trec_docs

    monkeypatch.delenv("CAPREOLUS_NATIVE", raising=False)
    fn = tmp_path / "docs.trectxt"
    fn.write_text(_trec_blocks(np.random.Generator(np.random.PCG64(0)), 40))
    ours = native.native_parse_trec(fn.read_bytes())
    assert ours == jax_native.native_parse_trec(fn.read_bytes())
    # a list is never `is` the default tuple: the Python parser
    python = list(iterate_trec_docs(fn, content_tags=list(TREC_CONTENT_TAGS)))
    assert ours == python == list(iterate_trec_docs(fn)) == list(jax_iterate_trec_docs(fn))
    assert len(ours) == 40 and ours[0][0] == "NT000" and "ignored section" not in ours[0][1]
    # a gzipped file goes through Python, with the same documents
    gz = tmp_path / "docs.trectxt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write(fn.read_text())
    assert list(iterate_trec_docs(gz)) == ours
    monkeypatch.setenv("CAPREOLUS_NATIVE", "0")
    assert native.native_parse_trec(fn.read_bytes()) is None and list(iterate_trec_docs(fn)) == ours


def test_krovetz_stems_equal_jax():
    rng = np.random.Generator(np.random.PCG64(1))
    words = ("cities ponies children teeth went taken lives knives news species virus being running hopping "
             "hopped created creating loved carried carries walked walks boxes wishes glasses buses caresses "
             "making sing king ties is was has this analysis gases focusing statuses corpora agreed fed "
             "nationalization hopefulness").split()
    suffixes = ["", "s", "es", "ies", "ed", "ied", "ing", "ness"]
    for _ in range(400):
        stem = "".join(chr(97 + int(c)) for c in rng.integers(0, 26, int(rng.integers(1, 9))))
        words.append(stem + suffixes[int(rng.integers(0, len(suffixes)))])
    for w in words:
        assert kstem(w) == jax_kstem(w), w
    for text in TEXTS + fuzz_texts(99, 20) + ["café naïve Zürich running", "The cities' children were hopping"]:
        assert EnglishAnalyzer("krovetz").analyze(text) == JaxEnglishAnalyzer("krovetz").analyze(text), text


def test_without_gxx_or_switched_off_every_caller_falls_back(monkeypatch, tmp_path):
    monkeypatch.setenv("CAPREOLUS_NATIVE", "0")
    assert native.native_status() == {name: {"loaded": False, "reason": "CAPREOLUS_NATIVE=0"}
                                      for name in native.LIBRARIES}
    assert native.get_analyzer_lib() is None and native.native_porter_stem("running") is None
    monkeypatch.delenv("CAPREOLUS_NATIVE")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_status", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    native.logger.addHandler(handler)
    try:
        status = native.native_status()
    finally:
        native.logger.removeHandler(handler)
    assert all(not st["loaded"] and "g++ not found" in st["reason"] for st in status.values()), status
    assert sum(r.levelno == logging.WARNING and "unavailable" in r.getMessage() for r in records) == 3
    assert native.native_analyze("running cats", True, False) is None
    assert EnglishAnalyzer().analyze("The cats were running") == ["cat", "were", "run"]


def test_two_processes_building_one_library_both_load_it(tmp_path):
    code = ("import json, sys\nfrom pathlib import Path\nimport capreolus_tpu_torch.native as n\n"
            "n.BUILD_DIR = Path(sys.argv[1])\nprint(json.dumps(n.native_status()))\n")
    env = {k: v for k, v in os.environ.items() if k != "CAPREOLUS_NATIVE"}
    env["PYTHONPATH"] = str(ROOT)
    build_dir = tmp_path / "native"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build_dir)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    for out, _ in outs:
        status = json.loads(out.strip().splitlines()[-1])
        assert all(st["loaded"] for st in status.values()), status
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(
        native.library_path(name).name for name in native.LIBRARIES)  # no temporary file left behind
