"""The port's parallelism layer (``unionml_tpu_torch/parallel``) against the
JAX package's, on the CPU.

- ``MeshSpec.axis_sizes`` and ``num_devices_required`` against JAX for every
  ``MeshSpec`` that ``tests/emulated`` and ``tests/unit`` build (an AST scan,
  plus their parametrized specs), at 1, 2, 4 and 8 devices, refusals
  included;
- ``PartitionRules.spec_for`` against JAX for every parameter path of tiny
  Llama and MoE trees (the port's module paths are the flax paths), and
  ``combine_fsdp_tp``'s inferred FSDP layout against JAX's;
- each mesh coordinate's shard (:func:`shard_slices`) against JAX's
  ``devices_indices_map`` slice and values, for ``model=4``, ``data=2 x
  model=2``, ``data=2 x fsdp=2`` and ``data=2 x expert=2``, int8 leaves
  (``q`` and the ``[1, F]``/``[E, 1, F]`` scales) included: no process
  needed;
- then one world of 4 gloo ranks (``tests/torch_mesh_ranks.py``): every
  collective over ``model`` and ``data`` of a ``data=2 x model=2`` mesh
  against numpy, each rank's placed weights, as ``Generator(mesh=...)``
  cut them, against JAX's shard for the same mesh coordinate, a LoRA
  model's placed adapters and tokens, and a biased column/row-parallel
  pair's gradients against the unplaced pair's.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import World
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models import llama_partition_rules as jax_llama_rules
from unionml_tpu.models.moe import MoEConfig as JaxMoEConfig, MoETransformer as JaxMoETransformer
from unionml_tpu.models.moe import moe_partition_rules as jax_moe_rules
from unionml_tpu.ops.quant import QuantizedTensor as JaxQuantizedTensor
from unionml_tpu.parallel.mesh import AXIS_ORDER as JAX_AXIS_ORDER, MeshSpec as JaxMeshSpec
from unionml_tpu.parallel.sharding import _path_str, combine_fsdp_tp as jax_combine_fsdp_tp
from unionml_tpu_torch.models import Generator, GenerationConfig, llama_from_jax, llama_partition_rules, moe_from_jax
from unionml_tpu_torch.models import moe_partition_rules
from unionml_tpu_torch.models.llama import LlamaConfig
from unionml_tpu_torch.models.moe import MoEConfig
from unionml_tpu_torch.parallel import MeshSpec, P, PartitionRules, combine_fsdp_tp, infer_fsdp_sharding
from unionml_tpu_torch.parallel.mesh import AXIS_ORDER
from unionml_tpu_torch.parallel.sharding import _leaves, scale_spec, shard_slices
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent
SPECS = [(dict(data=4, model=2)), dict(model=4), dict(data=4, fsdp=2), dict(data=1, sequence=8),
         dict(data=2, sequence=4), dict(data=2, model=2, fsdp=1), dict(data=-1, model=-1)]


def _scanned_specs():
    """Every ``MeshSpec(...)`` of the JAX tests whose arguments are int literals."""
    found = []
    for path in sorted((ROOT / "emulated").glob("*.py")) + sorted((ROOT / "unit").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "MeshSpec" and not node.args:
                try:
                    kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
                except ValueError:
                    continue
                if all(isinstance(v, int) for v in kw.values()) and kw not in found:
                    found.append(kw)
    return found


ALL_SPECS = _scanned_specs() + [s for s in SPECS if s not in _scanned_specs()]


def test_scan_finds_the_jax_tests_meshes():
    assert dict(data=2, model=2) in ALL_SPECS and dict(data=2, expert=4) in ALL_SPECS and len(ALL_SPECS) >= 15


@pytest.mark.parametrize("spec", ALL_SPECS, ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()) or "default")
def test_axis_sizes_match_jax(spec):
    assert AXIS_ORDER == JAX_AXIS_ORDER
    port, ref = MeshSpec(**spec), JaxMeshSpec(**spec)
    assert port.num_devices_required == ref.num_devices_required
    for n in (1, 2, 4, 8):
        try:
            expected = ref.axis_sizes(n)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc).split(" ")[0]):
                port.axis_sizes(n)
        else:
            assert port.axis_sizes(n) == expected


def seeded_params(module, seed: int):
    """A flax param tree for ``module`` filled from a seeded numpy stream
    (``jax.eval_shape`` gives the tree without compiling the init): kernels
    and tables scaled by their fan-in, norm scales near 1."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = _path_str(path)
        if name.endswith("scale"):
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(s.shape), jnp.float32)
        fan_in = s.shape[-1] if name.endswith("embedding") else s.shape[-2]
        return jnp.asarray(rng.standard_normal(s.shape) / np.sqrt(fan_in), jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_llama(**kw):
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **kw))
    return module, seeded_params(module, 1), kw


def _jax_moe(**kw):
    module = JaxMoETransformer(JaxMoEConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **kw))
    return module, seeded_params(module, 3), kw


LLAMA = dict(vocab_size=96, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128)
LLAMA_INT8 = dict(vocab_size=256, dim=256, n_layers=1, n_heads=8, n_kv_heads=4, hidden_dim=512)
MOE = dict(vocab_size=64, dim=128, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=512, n_experts=4, k=2,
           capacity_factor=8.0)


@pytest.fixture(scope="module")
def models():
    return {"llama": _jax_llama(**LLAMA), "llama_int8": _jax_llama(**LLAMA_INT8), "moe": _jax_moe(**MOE)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(kind, models):
    module, params, kw = models[kind]
    if kind == "moe":
        return moe_from_jax(_np_tree(params), MoEConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **kw),
                            device="cpu")
    return llama_from_jax(_np_tree(params), LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **kw),
                          device="cpu")


@pytest.mark.parametrize("kind", ["llama", "moe"])
def test_spec_for_matches_jax_on_every_path(models, kind):
    _, params, _ = models[kind]
    port_rules, ref_rules = (llama_partition_rules(), jax_llama_rules()) if kind == "llama" else \
        (moe_partition_rules(), jax_moe_rules())
    paths = [_path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert {p for p, _ in _leaves(_port(kind, models))} == set(paths)  # the port's paths are the flax paths
    for path in paths:
        ref = ref_rules.spec_for(path)
        got = port_rules.spec_for(path)
        assert (None if ref is None else tuple(ref)) == (None if got is None else tuple(got)), path
    assert PartitionRules([(r"nothing", P("model"))]).spec_for(paths[0]) is None


def _strip(spec):
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


class _Shape:
    """The mesh attributes the rule resolvers read, for a mesh of no process."""

    def __init__(self, sizes):
        self.shape, self.axis_names = dict(sizes), AXIS_ORDER


@pytest.mark.parametrize("rules", ["llama", "none"])
def test_combine_fsdp_tp_matches_jax(models, rules):
    _, params, _ = models["llama_int8"]
    mesh = JaxMeshSpec(data=2, fsdp=2, model=2).build()
    fake = _Shape(MeshSpec(data=2, fsdp=2, model=2).axis_sizes(8))
    ref = jax_combine_fsdp_tp(params, mesh, jax_llama_rules() if rules == "llama" else None, min_weight_size=2**12)
    got = combine_fsdp_tp(_np_tree(params), fake, llama_partition_rules() if rules == "llama" else None,
                          min_weight_size=2**12)
    flat = {_path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert set(flat) == set(got)
    for path, sharding in flat.items():
        assert _strip(got[path].spec) == _strip(sharding.spec), path
    inferred = infer_fsdp_sharding(_np_tree(params), fake, min_weight_size=2**12)
    assert any("fsdp" in tuple(s.spec) for s in inferred.values())


PLACEMENTS = [("llama", dict(model=4)), ("llama", dict(data=2, model=2)), ("llama", dict(data=2, fsdp=2)),
              ("llama_int8", dict(data=2, model=2)), ("llama_int8", dict(fsdp=2, model=2)),
              ("moe", dict(data=2, expert=2)), ("moe_int8", dict(data=2, expert=2))]


def _jax_placed(models, kind, spec, quantize):
    """JAX's placed params (Generator placement) and its 4-device mesh."""
    module, params, _ = models[kind]
    rules = jax_moe_rules() if kind == "moe" else jax_llama_rules()
    mesh = JaxMeshSpec(**{"data": 1, **spec}).build(jax.devices()[:4])
    gen = JaxGenerator(module, params, JaxGenerationConfig(max_new_tokens=2), mesh=mesh, partition_rules=rules,
                       quantize=quantize)
    return gen.params, mesh


def _jax_shards(placed, mesh):
    """``{(port state-dict name, coordinate tuple): array}`` of every placed leaf."""
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(placed, is_leaf=lambda x: isinstance(x, JaxQuantizedTensor))[0]
    for path, leaf in leaves:
        name = _path_str(path).replace("/", ".")
        arrays = {name + ".q": leaf.q, name + ".scale": leaf.scale} if isinstance(leaf, JaxQuantizedTensor) \
            else {name: leaf}
        for key, arr in arrays.items():
            full = np.asarray(arr)
            for device, index in arr.sharding.devices_indices_map(full.shape).items():
                coord = tuple(int(c) for c in np.argwhere(mesh.devices == device)[0])
                out[key, coord] = (index, full[index])
    return out


def _norm(index, shape):
    return tuple(s.indices(n)[:2] for s, n in zip(index, shape))


@pytest.mark.parametrize("kind,spec", PLACEMENTS, ids=lambda x: x if isinstance(x, str) else
                         ",".join(f"{k}={v}" for k, v in x.items()))
def test_shard_slices_match_devices_indices_map(models, kind, spec):
    """Every coordinate's port slice of every leaf is JAX's slice of the
    same leaf, and holds the same values (int8 values and scales too)."""
    base = "moe" if kind.startswith("moe") else kind
    placed, mesh = _jax_placed(models, base, spec, "int8" if "int8" in kind else None)
    model = _port(base, models)
    if "int8" in kind:
        from unionml_tpu_torch.ops.quant import quantize_params

        quantize_params(model)
    rules = moe_partition_rules() if kind.startswith("moe") else llama_partition_rules()
    sizes = MeshSpec(**{"data": 1, **spec}).axis_sizes(4)
    shardings = combine_fsdp_tp(model, _Shape(sizes), rules)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    specs = {}
    for path, sharding in shardings.items():
        name = path.replace("/", ".")
        if name + ".q" in state:
            specs[name + ".q"] = sharding.spec
            specs[name + ".scale"] = scale_spec(state[name + ".scale"].shape, sharding.spec)
        else:
            specs[name] = sharding.spec
    assert set(specs) == set(state)
    ref = _jax_shards(placed, mesh)
    assert {k for k, _ in ref} == set(state)
    for (name, coord), (index, values) in ref.items():
        coordinate = dict(zip(AXIS_ORDER, coord))
        got = shard_slices(state[name].shape, specs[name], sizes, coordinate)
        assert _norm(got, state[name].shape) == _norm(index, state[name].shape), (name, coord)
        np.testing.assert_array_equal(state[name][got], values, err_msg=f"{name} at {coord}")


# ---------------------------------------------------------------------------
# one world of 4 ranks


@pytest.fixture(scope="module", autouse=True)
def started_world(models, tmp_path_factory):
    """The world of 4 ranks, started before this file's first test: it runs
    while the single-process tests above run."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 4, 6).astype(np.float32)
    placements = [("llama/int8", dict(data=2, model=2)), ("llama/", dict(model=4)), ("llama/", dict(data=2, fsdp=2)),
                  ("moe/int8", dict(data=2, expert=2))]
    payload = {
        "x": x,
        "placements": placements,
        "trees": {"llama": _np_tree(models["llama_int8"][1]), "moe": _np_tree(models["moe"][1])},
        "configs": {"llama": LLAMA_INT8, "moe": MOE},
    }
    return x, placements, World(4, "parallel_rank", payload, tmp_path_factory.mktemp("parallel"))


@pytest.fixture(scope="module")
def world(started_world):
    x, placements, world = started_world
    return x, placements, world.results()


def _groups(results, axis):
    """Ranks grouped by their coordinate on every axis but ``axis``, each
    group ordered by ``axis``."""
    groups = {}
    for rank, res in enumerate(results):
        c = res["coordinate"]
        key = tuple(v for k, v in c.items() if k != axis)
        groups.setdefault(key, []).append((c[axis], rank))
    return [[r for _, r in sorted(g)] for g in groups.values()]


@pytest.mark.parametrize("axis", ["model", "data"])
@pytest.mark.parametrize("op", ["index", "sum", "mean", "gather", "stack", "scatter", "ring", "a2a", "bcast"])
def test_collectives_match_numpy(world, axis, op):
    x, _, results = world
    for group in _groups(results, axis):
        xs = [x[r] for r in group]
        n = len(group)
        for i, rank in enumerate(group):
            got = results[rank]
            if op == "index":
                assert got[f"index/{axis}"] == (i, n)
            elif op == "sum":
                np.testing.assert_allclose(got[f"sum/{axis}"], 2 * sum(xs), rtol=1e-6)
            elif op == "mean":
                np.testing.assert_allclose(got[f"mean/{axis}"], sum(xs) / n, rtol=1e-6)
            elif op in ("gather", "stack"):
                for dim in (0, 1):
                    ref = np.concatenate(xs, axis=dim) if op == "gather" else np.stack(xs, axis=dim)
                    np.testing.assert_array_equal(got[f"{op}/{axis}/{dim}"], ref)
            elif op == "scatter":
                for dim in (0, 1):
                    ref = np.split(sum(xs), n, axis=dim)[i]
                    np.testing.assert_allclose(got[f"scatter/{axis}/{dim}"], ref, rtol=1e-6)
            elif op == "ring":
                np.testing.assert_array_equal(got[f"ring/{axis}"], xs[(i - 1) % n] + 1)
                np.testing.assert_array_equal(got[f"ring2/{axis}"], xs[(i + 1) % n])
            elif op == "a2a":
                ref = np.concatenate([np.split(xs[j], n, axis=0)[i] for j in range(n)], axis=1)
                np.testing.assert_array_equal(got[f"a2a/{axis}"], ref)
                ref = np.concatenate([np.split(xs[j], n, axis=1)[i] for j in range(n)], axis=0)
                np.testing.assert_array_equal(got[f"a2a10/{axis}"], ref)
            elif op == "bcast":
                np.testing.assert_array_equal(got[f"bcast/{axis}"], xs[1])
            assert got["host_route"] == 0


@pytest.mark.parametrize("which", range(4))
def test_each_rank_holds_jax_shard(models, world, which):
    """Each rank's weights after ``Generator(mesh=..., partition_rules=...)``
    (and ``quantize="int8"``) equal JAX's shard for its mesh coordinate."""
    _, placements, results = world
    name, spec = placements[which]
    kind, quantize = name.split("/")
    placed, mesh = _jax_placed(models, "llama_int8" if kind == "llama" else "moe", spec, quantize or None)
    ref = _jax_shards(placed, mesh)
    for res in results:
        coordinate, state = res[f"placed/{name}/{sorted(spec.items())}"]
        coord = tuple(coordinate[a] for a in AXIS_ORDER)
        assert {k for k, c in ref if c == coord} == set(state)
        for key, arr in state.items():
            np.testing.assert_array_equal(arr, ref[key, coord][1], err_msg=f"{key} at {coord}")


def test_placement_places_lora_adapters(world):
    """A LoRA model is placed at ``model=4``: each rank holds JAX's
    ``lora_a`` ``P("fsdp", None)`` (whole here) and its ``lora_b`` columns
    ``P(None, "model")``, and its greedy tokens equal the unplaced model's."""
    from tests.torch_mesh_ranks import _seeded_lora

    model = _seeded_lora(LLAMA_INT8)
    whole = {n: p.detach().numpy() for n, p in model.named_parameters() if "lora" in n}
    tokens = Generator(model, GenerationConfig(max_new_tokens=2, temperature=0.0, prompt_buckets=(8,)),
                       device="cpu")([[5, 6, 7], [9]])
    for res in world[2]:
        shards, got, index = res["lora_placed"]
        for name, value in shards.items():
            if name.endswith("lora_a"):
                np.testing.assert_array_equal(value, whole[name])
            else:
                np.testing.assert_array_equal(value, np.split(whole[name], 4, axis=1)[index])
        np.testing.assert_array_equal(np.asarray(got), np.asarray(tokens))


def test_column_and_row_parallel_adapters_and_biases_train(world):
    """A column-parallel then a row-parallel ``LoRADense``, each with an
    adapter and a bias, over ``fsdp=2, model=2``: the output equals the
    unplaced pair's, and every rank's gradient of every leaf (kernels,
    adapters, biases) is its shard of the unplaced pair's, within 1e-5
    relative (the gradients reach ~100; f32 sums in other orders).
    The column bias is sliced to the rank's columns, the row bias added
    once after the sum."""
    for res in world[2]:
        got = res["lora_dense"]
        y, want = got["y"]
        np.testing.assert_allclose(y, want, atol=1e-5)
        for name, grad in got["grads"].items():
            full = got["whole"][name]
            index = shard_slices(full.shape, got["specs"][name], got["sizes"], got["coordinate"])
            np.testing.assert_allclose(grad, full[index], rtol=1e-5, atol=1e-5, err_msg=name)
        assert got["specs"]["0.kernel"] == ("fsdp", "model") and got["specs"]["1.bias"] == ()


def test_gradient_buckets_reduce_in_place(world):
    """``train.driver``'s gradient reduction over ``data=2, fsdp=2`` gives every
    rank the mean of the four ranks' gradients, within 1e-6, in the same
    tensors and layouts (a transposed leaf stays transposed): at the
    default cap in one collective an axis; at a 64-byte cap with the small
    leaves sharing buffers of at most 16 floats and the large ones reduced
    in slices of at most 16."""
    for res in world[2]:
        got = res["buckets"]
        for cap, (grads, calls, contiguous) in got["by_cap"].items():
            for g, want in zip(grads, got["want"]):
                np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6, err_msg=str(cap))
            assert contiguous == [True] * 5 + [False]
            if cap == 64:
                assert max(calls) == 16 and len(calls) > 2 * 6 and sum(calls) == 2 * sum(w.size for w in got["want"])
            else:
                assert calls == [sum(w.size for w in got["want"])] * 2


def test_checkpointed_loss_recomputes_in_the_reduce_scope(world):
    """A checkpointed loss's recompute runs where the backward runs, which
    on the card is autograd's device thread, not the thread that entered
    ``reduce_scope``: it must still take ``batch_mean``'s global quotient.
    Ranks count 1-4 entries (10 in all) of a loss ``sum(x^2)`` with ``x =
    (1, 2, 3)``: each rank's share is ``4 * 14 / 10`` and its gradient
    ``4 * 2x / 10``, checkpointed or not."""
    for res in world[2]:
        for name in ("plain", "remat"):
            value, grad = res["recomputed"][name]
            assert value == pytest.approx(4 * 14 / 10, rel=1e-6), name
            np.testing.assert_allclose(grad, 0.8 * np.arange(1.0, 4.0), rtol=1e-6, err_msg=name)


def test_world_agreement_primitives(world):
    """``distributed``'s helpers inside the world: every rank gets rank 0's
    value from ``agree`` and every rank's integer, in rank order."""
    _, _, results = world
    for rank, res in enumerate(results):
        assert res["distributed"] == (True, rank, 4, {"from": 0}, [0, 10, 20, 30])


@pytest.mark.parametrize("env", [{}, {"UNIONML_TPU_NUM_PROCESSES": "4", "UNIONML_TPU_PROCESS_ID": "2"},
                                 {"UNIONML_TPU_NUM_PROCESSES": "x", "UNIONML_TPU_PROCESS_ID": "-1"}])
def test_single_process_helpers_match_jax(monkeypatch, env):
    """With no coordinator the helpers are single-process no-ops that read
    the env as the JAX package's do (garbage degrades to 1 and 0)."""
    from unionml_tpu import distributed as jax_distributed
    from unionml_tpu_torch import distributed

    for name in ("UNIONML_TPU_COORDINATOR", "UNIONML_TPU_NUM_PROCESSES", "UNIONML_TPU_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert not distributed.maybe_initialize() and not distributed.is_initialized()
    assert distributed.process_index() == jax_distributed.process_index()
    assert distributed.process_count() == jax_distributed.process_count()
    assert distributed.agree({"a": 1}) == jax_distributed.agree({"a": 1}) == {"a": 1}
    assert distributed.allgather_ints(7) == jax_distributed.allgather_ints(7) == [7]
    distributed.barrier("x")


@pytest.mark.parametrize("sizes", [dict(data=4, model=2), dict(data=2, fsdp=2, model=2), dict(dcn_data=2, data=2, fsdp=2),
                                   dict(data=1, model=8)])
def test_batch_shardings_match_jax(sizes):
    from unionml_tpu.parallel.sharding import batch_axis_size as jax_batch_axis_size
    from unionml_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
    from unionml_tpu.parallel.sharding import named_sharding as jax_named_sharding
    from unionml_tpu_torch.parallel import batch_sharding, named_sharding
    from unionml_tpu_torch.parallel.sharding import batch_axis_size, replicated

    mesh = JaxMeshSpec(**sizes).build()
    fake = _Shape(MeshSpec(**sizes).axis_sizes(8))
    assert tuple(batch_sharding(fake).spec) == tuple(jax_batch_sharding(mesh).spec)
    assert batch_axis_size(fake) == jax_batch_axis_size(mesh)
    assert tuple(named_sharding(fake, "data", None).spec) == tuple(jax_named_sharding(mesh, "data", None).spec)
    assert tuple(replicated(fake).spec) == ()


def test_mesh_build_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MeshSpec(data=1).build()
    from unionml_tpu.parallel.mesh import process_local_submeshes as jax_process_local_submeshes
    from unionml_tpu_torch.parallel.mesh import process_local_submeshes

    with pytest.raises(RuntimeError, match='device="cpu"'):
        MeshSpec().build_hybrid()
    assert process_local_submeshes([]) == jax_process_local_submeshes([]) == []


def test_generator_places_the_model_it_is_given():
    """Placement needs a built mesh; a spec is refused before any process
    group exists."""
    model = llama_from_jax(_np_tree(_jax_llama(**LLAMA)[1]), LlamaConfig.tiny(dtype=torch.float32,
                           param_dtype=torch.float32, **LLAMA), device="cpu")
    with pytest.raises(TypeError, match="MeshSpec"):
        Generator(model, GenerationConfig(), device="cpu", mesh=MeshSpec(model=2))
