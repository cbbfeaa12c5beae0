"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package (nor HuggingFace ``transformers``: it downloads nothing), and its
module registry is its own.

``capreolus_tpu_torch`` starts with ``capreolus_tpu``, so a forbidden module is
``capreolus_tpu`` itself or a name under ``capreolus_tpu.``, never a prefix match.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import capreolus_tpu
import capreolus_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "transformers")


def is_forbidden(module_name: str) -> bool:
    return (module_name.split(".")[0] in FORBIDDEN_ROOTS or module_name == "capreolus_tpu"
            or module_name.startswith("capreolus_tpu."))


def test_forbidden_name_rule():
    assert is_forbidden("capreolus_tpu") and is_forbidden("capreolus_tpu.ops.simmat")
    assert is_forbidden("jax.numpy") and is_forbidden("flax.linen") and is_forbidden("transformers.models")
    assert not is_forbidden("capreolus_tpu_torch") and not is_forbidden("capreolus_tpu_torch.ops")
    assert not is_forbidden("jaxtyping_like")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import capreolus_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(capreolus_tpu_torch.__path__, 'capreolus_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps({'imported': names, 'before': sorted(before), 'after': sorted(sys.modules)}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"capreolus_tpu_torch.serving", "capreolus_tpu_torch.ops.simmat",
            "capreolus_tpu_torch.searcher.scoring", "capreolus_tpu_torch.convert",
            "capreolus_tpu_torch.ops.flash_attention", "capreolus_tpu_torch.reranker.bert_rerankers",
            "capreolus_tpu_torch.reranker.bert.encoder", "capreolus_tpu_torch.extractor.bertpassage",
            "capreolus_tpu_torch.tokenizer.wordpiece", "capreolus_tpu_torch.ops.maxsim",
            "capreolus_tpu_torch.reranker.colbert", "capreolus_tpu_torch.searcher.late_interaction",
            "capreolus_tpu_torch.utils.caching", "capreolus_tpu_torch.ops.int8_matmul",
            "capreolus_tpu_torch.ops.quantization", "capreolus_tpu_torch.trainer.torch_trainer",
            "capreolus_tpu_torch.sampler", "capreolus_tpu_torch.task.rerank",
            "capreolus_tpu_torch.utils.flax_msgpack", "capreolus_tpu_torch.utils.tensorboard"} <= set(out["imported"])
    loaded = set(out["after"]) - set(out["before"])
    assert not sorted(m for m in loaded if is_forbidden(m))
    # absent altogether, unless the interpreter's own start-up had loaded it
    if not any(is_forbidden(m) for m in out["before"]):
        assert not sorted(m for m in out["after"] if is_forbidden(m))


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted((ROOT / "capreolus_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): bad for f in files
                 if (bad := sorted(n for n in _imported_names(f) if is_forbidden(n)))}
    assert offenders == {}


def test_registries_are_separate():
    capreolus_tpu.load_all_modules()
    capreolus_tpu_torch.load_all_modules()
    from capreolus_tpu.index import Index as JaxIndex
    from capreolus_tpu.reranker import Reranker as JaxReranker
    from capreolus_tpu_torch.index import Index as TorchIndex
    from capreolus_tpu_torch.reranker import Reranker as TorchReranker

    assert JaxReranker.lookup("KNRM").__module__ == "capreolus_tpu.reranker.knrm"
    assert JaxIndex.lookup("tpu").__module__ == "capreolus_tpu.index.tpu"
    assert TorchReranker.lookup("KNRM").__module__ == "capreolus_tpu_torch.reranker.knrm"
    assert TorchIndex.lookup("tpu").__module__ == "capreolus_tpu_torch.index.tpu"
    assert capreolus_tpu.module_registry is not capreolus_tpu_torch.module_registry
    assert capreolus_tpu_torch.constants["BASE_PACKAGE"] == "capreolus_tpu_torch"
    assert json.dumps(capreolus_tpu_torch.module_registry.get_module_types()) == json.dumps(
        ["benchmark", "collection", "extractor", "index", "reranker", "sampler", "searcher", "task", "tokenizer",
         "trainer"])
