"""Boundaries of the PyTorch/CUDA port.

- No module of ``unionml_tpu_torch``, not ``chip_smoke.py`` and no script
  under ``scripts/`` imports JAX, flax, optax or the JAX package (an AST scan; names are matched exactly,
  since ``unionml_tpu_torch`` itself starts with ``unionml_tpu``).
- The entry points run on the card unless the caller asks for the CPU: with
  no CUDA device, ``device=None`` raises and names ``device="cpu"``.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from unionml_tpu_torch import (
    ContinuousBatcher,
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    TrainerConfig,
    TrainState,
    evaluate,
    fit,
    make_train_step,
)
from unionml_tpu_torch.data import PrefetchIterator
from unionml_tpu_torch.parallel import MeshSpec
from unionml_tpu_torch.ops.quant import QuantizedKernel
from unionml_tpu_torch.models import causal_lm_loss, init_cache, init_paged_cache, llama_from_jax, llama_params_to_numpy
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "unionml_tpu")
PORT_FILES = (
    sorted((ROOT / "unionml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "scripts").glob("*.py"))
)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", None)) in (
            "import_module", "__import__",
        ):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_scan_sees_every_port_module():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "unionml_tpu_torch/ops/paged_attention.py",
            "unionml_tpu_torch/ops/flash_attention.py", "unionml_tpu_torch/serving/continuous.py",
            "unionml_tpu_torch/train/driver.py", "unionml_tpu_torch/data/pipeline.py"} <= names
    assert {"unionml_tpu_torch/ops/int8_matmul.py", "unionml_tpu_torch/ops/quant.py",
            "unionml_tpu_torch/defaults.py", "scripts/flash_forward_ab.py"} <= names
    assert {"unionml_tpu_torch/model.py", "unionml_tpu_torch/dataset.py", "unionml_tpu_torch/stage.py",
            "unionml_tpu_torch/artifact.py", "unionml_tpu_torch/type_guards.py", "unionml_tpu_torch/_logging.py",
            "unionml_tpu_torch/utils/__init__.py", "unionml_tpu_torch/native/__init__.py",
            "unionml_tpu_torch/templates/text-generation/app.py",
            "unionml_tpu_torch/templates/text-generation/tests/test_app.py"} <= names
    assert {"unionml_tpu_torch/distributed.py", "unionml_tpu_torch/parallel/__init__.py",
            "unionml_tpu_torch/parallel/mesh.py", "unionml_tpu_torch/parallel/sharding.py",
            "unionml_tpu_torch/parallel/collectives.py", "unionml_tpu_torch/ops/ring_attention.py",
            "unionml_tpu_torch/serving/mesh.py"} <= names
    assert {"unionml_tpu_torch/models/bert.py", "unionml_tpu_torch/models/vit.py", "unionml_tpu_torch/models/mlp.py",
            "unionml_tpu_torch/templates/image-classification/app.py",
            "unionml_tpu_torch/templates/image-classification/tests/test_app.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "module,expected",
    [("unionml_tpu_torch.models", False), ("unionml_tpu", True), ("unionml_tpu.models.llama", True),
     ("jax.numpy", True), ("flax.linen", True), ("optax", True), ("jaxtyping", False)],
)
def test_forbidden_names_match_exactly(module, expected):
    assert _forbidden(module) is expected


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize(
    "entry",
    ["Llama", "Generator", "ContinuousBatcher", "init_cache", "init_paged_cache", "PrefetchIterator", "fit",
     "evaluate", "Generator-int8", "llama_from_jax", "MeshSpec.build"],
)
def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, entry):
    cfg = LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=32, vocab_size=16,
                           dtype=torch.float32, param_dtype=torch.float32)
    cpu_model = Llama(cfg, device="cpu", seed=0)
    state = TrainState(cpu_model, torch.optim.SGD(cpu_model.parameters(), lr=0.1))
    tokens = np.zeros((4, 5), np.int32)
    _no_cuda(monkeypatch)
    calls = {
        "Llama": lambda: Llama(cfg),
        "Generator": lambda: Generator(cpu_model, GenerationConfig()),
        "Generator-int8": lambda: Generator(cpu_model, GenerationConfig(), quantize="int8"),
        "llama_from_jax": lambda: llama_from_jax(llama_params_to_numpy(cpu_model), cfg),
        "ContinuousBatcher": lambda: ContinuousBatcher(Generator(cpu_model, GenerationConfig())),
        "init_cache": lambda: init_cache(cfg, 1, 8),
        "init_paged_cache": lambda: init_paged_cache(cfg, 1, 3, 4, 2, fill_block=2),
        "PrefetchIterator": lambda: PrefetchIterator(tokens, 2),
        "fit": lambda: fit(state, make_train_step(causal_lm_loss), tokens, TrainerConfig(batch_size=2)),
        "evaluate": lambda: evaluate(state, lambda s, b: {}, tokens),
        "MeshSpec.build": lambda: MeshSpec(model=1).build(),  # the card (NCCL) unless device="cpu" (gloo)
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert not any(isinstance(m, QuantizedKernel) for m in cpu_model.modules())  # refused before quantizing


def test_cpu_must_be_asked_for_and_then_works():
    cfg = LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=32, vocab_size=16,
                           dtype=torch.float32, param_dtype=torch.float32)
    model = Llama(cfg, device="cpu", seed=0)
    gen = Generator(model, GenerationConfig(max_new_tokens=3, temperature=0.0, prompt_buckets=(8,)), device="cpu")
    assert gen.device == torch.device("cpu")
    assert gen([[1, 2, 3]]).shape == (1, 3)
    with pytest.raises(ValueError, match="lives on"):
        Generator(model, GenerationConfig(), device="meta")
