"""The port covers the JAX package: every module file of ``capreolus_tpu/``
has its counterpart at the same path under ``capreolus_tpu_torch/``, and every
public name of a JAX module (top-level functions, classes and assignments,
and each class's public methods) exists in its counterpart module, or stands
in a table below with the port's counterpart (checked to exist) or the reason
none is needed. The names the port gained last (``parse_config_string``,
``Index.get_docs``, ``OrderedDefaultDict``, the analyzers' ``cache_key``,
``DummyCollection.doc_count_hint``, ``stacked_similarity_matrix``) are each
held against JAX's.

Tolerances: ``stacked_similarity_matrix`` within 1e-6 (f32 cosines, summed in
other orders); everything else equal.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import capreolus_tpu
import capreolus_tpu_torch

capreolus_tpu_torch.load_all_modules()

from test_torch_index import torch_cache  # noqa: E402,F401

ROOT = Path(__file__).resolve().parent.parent
JAX_ROOT, PORT_ROOT = ROOT / "capreolus_tpu", ROOT / "capreolus_tpu_torch"
JAX_FILES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))

# the one module file whose counterpart has another name, and its class
RENAMED_FILES = {"trainer/jax_trainer.py": "trainer/torch_trainer.py"}
RENAMED_CLASSES = {("trainer/jax_trainer.py", "JaxTrainer"): "TorchTrainer"}

# JAX public names without a namesake in the port, and the port's counterpart (module:attribute)
COUNTERPARTS = {
    "extractor/embeddings.py::EMBEDDING_SOURCES": "capreolus_tpu_torch.extractor.embeddings:EMBEDDING_DIMS",
    "ops/quantization.py::quantize_rows_jnp": "capreolus_tpu_torch.ops.quantization:quantize_rows_torch",
    "ops/quantization.py::unpack_int4_jnp": "capreolus_tpu_torch.ops.quantization:unpack_int4",
    "reranker/__init__.py::Reranker.fold_rngs": "capreolus_tpu_torch.trainer.torch_trainer:TorchTrainer.step_seed",
    "reranker/bert/encoder.py::Int8Dense": "capreolus_tpu_torch.reranker.bert.encoder:Int8Linear",
    "reranker/bert/encoder.py::load_pretrained_mlm_head": "capreolus_tpu_torch.reranker.splade:load_pretrained_mlm_head",
    "reranker/bert_rerankers.py::BERT_BATCH_KEYS": "capreolus_tpu_torch.trainer.collate:ARRAY_KEYS",
    "reranker/bert_rerankers.py::BertRerankerBase.build_test_model":
        "capreolus_tpu_torch.reranker.bert_rerankers:BertRerankerBase.prepare_inference",
    "reranker/bert_rerankers.py::BertRerankerBase.inference_variables":
        "capreolus_tpu_torch.reranker.bert_rerankers:BertRerankerBase.prepare_inference",
    "reranker/biencoder.py::BiEncoderModel.setup": "capreolus_tpu_torch.reranker.biencoder:BiEncoderModel.__init__",
    "reranker/colbert.py::ColBERTModel.setup": "capreolus_tpu_torch.reranker.colbert:ColBERTModel.__init__",
}
_NO_LOG = "the port's module logs nothing, so it makes no logger"
# JAX public names without a counterpart in the port, and why none is needed
NOT_NEEDED = {
    "collection/__init__.py::logger": _NO_LOG,
    "extractor/bertpassage.py::logger": _NO_LOG,
    "index/__init__.py::logger": _NO_LOG,
    "reranker/__init__.py::logger": _NO_LOG,
    "reranker/unicoil.py::logger": _NO_LOG + " (its encoder loads its weights without a message)",
    "searcher/__init__.py::logger": _NO_LOG,
    "utils/trec.py::logger": _NO_LOG,
    "ops/flash_attention.py::BLOCK_Q": "the Pallas kernel's VMEM block rows; K2's tiles are fixed in "
                                       "csrc/flash_attention.cu",
    "ops/flash_attention.py::BLOCK_K": "the Pallas kernel's VMEM key block; K2's tiles are fixed in "
                                       "csrc/flash_attention.cu",
    "tokenizer/__init__.py::BertTokenizer.bert_tokenizer": "an attribute that the port's build() sets (a lazy "
                                                           "property in JAX, whose HuggingFace branch the port "
                                                           "leaves out: it never imports transformers)",
    "trainer/jax_trainer.py::TRAIN_PIPELINE_DEPTH": "how many jitted steps JAX dispatches before it reads a loss; "
                                                    "the port's steps run eagerly, a producer thread collating "
                                                    "the batches ahead",
}


def public_names(path):
    """Top-level public functions, classes and assigned names of a module, and
    each public class's public methods as ``Class.method``."""
    names = []
    for node in ast.parse(Path(path).read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{b.name}" for b in node.body
                          if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) and not b.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name) and not t.id.startswith("_")]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if not node.target.id.startswith("_"):
                names.append(node.target.id)
    return names


def port_module(rel):
    parts = Path(RENAMED_FILES.get(rel, rel)).with_suffix("").parts
    parts = parts[:-1] if parts[-1] == "__init__" else parts
    return importlib.import_module(".".join(("capreolus_tpu_torch",) + parts))


def resolve(obj, dotted):
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return None
        obj = getattr(obj, part)
    return obj


def test_every_jax_module_file_has_its_counterpart():
    assert len(JAX_FILES) > 100
    missing = [rel for rel in JAX_FILES if not (PORT_ROOT / RENAMED_FILES.get(rel, rel)).is_file()]
    assert not missing
    assert "utils/irds.py" in JAX_FILES and (PORT_ROOT / "utils" / "irds.py").is_file()


def test_the_trainer_registered_as_jax_is_the_ports():
    from capreolus_tpu_torch.trainer import Trainer
    from capreolus_tpu_torch.trainer.torch_trainer import TorchTrainer

    assert Trainer.lookup("jax") is TorchTrainer
    assert {"pytorch", "tensorflow"} <= set(capreolus_tpu_torch.module_registry.get_module_names("trainer"))
    for name in ("pytorch", "tensorflow"):
        assert issubclass(Trainer.lookup(name), TorchTrainer)


@pytest.mark.parametrize("rel", JAX_FILES)
def test_public_names_have_counterparts(rel):
    module = port_module(rel)
    unmatched = []
    for name in public_names(JAX_ROOT / rel):
        head, _, rest = name.partition(".")
        renamed = RENAMED_CLASSES.get((rel, head), head)
        if resolve(module, f"{renamed}.{rest}" if rest else renamed) is None:
            unmatched.append(f"{rel}::{name}")
    listed = sorted(key for key in {**COUNTERPARTS, **NOT_NEEDED} if key.startswith(f"{rel}::"))
    assert sorted(unmatched) == listed  # each gap is in a table, and no table entry is stale
    for key in listed:
        if key in COUNTERPARTS:
            target_module, _, attr = COUNTERPARTS[key].partition(":")
            assert resolve(importlib.import_module(target_module), attr) is not None, key


def test_tables_name_only_jax_files():
    files = {key.split("::")[0] for key in {**COUNTERPARTS, **NOT_NEEDED}}
    assert files <= set(JAX_FILES) and not set(COUNTERPARTS) & set(NOT_NEEDED)


# ---------------------------------------------------------------- the names the port gained last
@pytest.mark.parametrize("config_string", [
    "searcher.index.stemmer=none searcher.index.collection.name=dummy searcher.k1=0.9,1.2",
    "reranker.name=KNRM reranker.extractor.embeddings=random8 reranker.trainer.niters=2 benchmark.name=dummy",
    "",
])
def test_parse_config_string_equals_jax(config_string):
    got, want = capreolus_tpu_torch.parse_config_string(config_string), capreolus_tpu.parse_config_string(config_string)
    assert got == want
    assert "parse_config_string" in capreolus_tpu_torch.__all__
    if config_string.startswith("searcher"):
        assert got["searcher"]["index"]["collection"]["name"] == "dummy"


def test_get_docs_on_the_dummy_index_equals_jax(tmpdir_as_cache, torch_cache):
    from capreolus_tpu.index import Index as JaxIndex
    from capreolus_tpu_torch.index import Index

    ours, ref = Index.create("tpu", {"collection": {"name": "dummy"}}), JaxIndex.create("tpu", {"collection": {"name": "dummy"}})
    ours.create_index()
    ref.create_index()
    docids = ["D001", "D003", "D001"]
    got = ours.get_docs(docids)
    assert got == ref.get_docs(docids) == [ref.get_doc(d) for d in docids]
    assert got[0] == got[2] != got[1]


def test_ordered_default_dict_equals_jax():
    from capreolus_tpu.utils.common import OrderedDefaultDict as JaxOrderedDefaultDict
    from capreolus_tpu_torch.utils.common import OrderedDefaultDict

    dicts = []
    for cls in (OrderedDefaultDict, JaxOrderedDefaultDict):
        d = cls(list)
        for key, value in (("b", 1), ("a", 2), ("c", 3), ("b", 4)):
            d[key].append(value)
        dicts.append(d)
        with pytest.raises(KeyError):
            cls()["missing"]
        assert cls(int)["x"] == 0
    assert list(dicts[0].items()) == list(dicts[1].items()) == [("b", [1, 4]), ("a", [2]), ("c", [3])]


@pytest.mark.parametrize("stemmer,keep", [("porter", False), ("porter", True), ("krovetz", False), ("none", True),
                                          ("whitespace", False), (None, False)])
def test_analyzer_cache_keys_equal_jax(stemmer, keep):
    from capreolus_tpu.analysis.analyzer import get_analyzer as jax_get_analyzer
    from capreolus_tpu_torch.analysis.analyzer import get_analyzer

    got, want = get_analyzer(stemmer, keep).cache_key(), jax_get_analyzer(stemmer, keep).cache_key()
    assert got == want and isinstance(got, str)


def test_dummy_collection_doc_count_hint_equals_jax():
    from capreolus_tpu.collection import Collection as JaxCollection
    from capreolus_tpu_torch.collection import Collection

    ours, ref = Collection.create("dummy"), JaxCollection.create("dummy")
    assert ours.doc_count_hint() == ref.doc_count_hint() == 3 == len(list(ours.get_doc_iterator()))


@pytest.mark.parametrize("layers", [1, 3])
def test_stacked_similarity_matrix_equals_jax(layers):
    import jax.numpy as jnp

    from capreolus_tpu.reranker.common import stacked_similarity_matrix as jax_stacked
    from capreolus_tpu_torch.reranker.common import stacked_similarity_matrix

    rng = np.random.default_rng(19)
    b, q, d, e = 3, 5, 11, 16
    query_tok = rng.integers(1, 50, size=(b, q))
    doc_tok = rng.integers(1, 50, size=(b, d))
    query_tok[:, -2:] = 0  # padding
    doc_tok[0, -4:] = 0
    q_embs = [rng.standard_normal((b, q, e)).astype(np.float32) for _ in range(layers)]
    d_embs = [rng.standard_normal((b, d, e)).astype(np.float32) for _ in range(layers)]
    got = stacked_similarity_matrix([torch.from_numpy(x) for x in q_embs], [torch.from_numpy(x) for x in d_embs],
                                    torch.from_numpy(query_tok), torch.from_numpy(doc_tok)).numpy()
    want = np.asarray(jax_stacked([jnp.asarray(x) for x in q_embs], [jnp.asarray(x) for x in d_embs],
                                  jnp.asarray(query_tok), jnp.asarray(doc_tok)))
    assert got.shape == want.shape == (b, layers, q, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[:, :, -2:].any() and not got[0, :, :, -4:].any()
