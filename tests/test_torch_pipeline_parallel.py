"""Pipeline parallelism (``unionml_tpu_torch/parallel/pipeline.py``), the
pipelined ViT and sequence-parallel gradients in the port against the JAX
package's, on the CPU.

One world of 4 gloo ranks (``tests/torch_mesh_ranks.py``) runs, on the same
stacked params and inputs (numpy, carried from JAX):

- the JAX tests' ``ToyStage`` through ``pipeline_apply`` at ``data=2,
  pipe=2`` (params whole but for the stage dim), at ``pipe=2, model=2``
  with ``param_specs`` (kernels split over ``model`` at rest, gathered
  inside) and at ``pipe=2, fsdp=2`` with ``P("pipe", None, ("fsdp",
  "model"))`` splits: each rank's output rows and its shards of the
  gradients of ``mean(out ** 2)`` (averaged over the batch axes by
  ``reduce_gradients``) against JAX's ``pipeline_apply`` and
  ``sequential_stage_apply``;
- a dim split over two axes (``fsdp=2, model=2``) gathered back minor axis
  first, forward and backward, against numpy;
- ring (``sequence=4``) and ulysses (``data=2, sequence=2``) attention
  gradients against JAX's (``tests/emulated/test_models.py``'s cases);
- one ``PipelinedViT`` train step at ``pipe=2, model=2`` under
  ``pipelined_vit_partition_rules()`` from the JAX tree (through
  ``pipelined_vit_from_jax``): loss and every rank's gradient shards against
  JAX's ``PipelinedViT.apply`` under ``jax.grad``, and the params move;
- a ``Generator`` over ``pipe=2, model=2``: greedy tokens equal JAX's
  unsharded ``Generator``'s;

and, in this process, the pipelined ViT's bridge there and back. All f32, within 1e-5 unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn
from jax.sharding import NamedSharding as JaxNamedSharding, PartitionSpec as JaxP

from tests.torch_mesh_ranks import World, threaded, toy_stage
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models.vit import PipelinedViT as JaxPipelinedViT, ViTConfig as JaxViTConfig
from unionml_tpu.models.vit import pipelined_vit_partition_rules as jax_pipelined_vit_rules
from unionml_tpu.ops.attention import dot_product_attention as jax_dot_product_attention
from unionml_tpu.ops.ring_attention import sequence_sharded_attention as jax_sequence_sharded_attention
from unionml_tpu.parallel import init_stage_params as jax_init_stage_params
from unionml_tpu.parallel import pipeline_apply as jax_pipeline_apply
from unionml_tpu.parallel import sequential_stage_apply as jax_sequential_stage_apply
from unionml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from unionml_tpu.parallel.sharding import _path_str
from unionml_tpu_torch.parallel import P, pipeline_apply, stage_call
from unionml_tpu_torch.parallel.sharding import shard_slices

torch.set_num_threads(2)


class ToyStage(nn.Module):
    dim: int = 16

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(self.dim * 2, dtype=jnp.float32)(x)
        return x + nn.Dense(self.dim, dtype=jnp.float32)(nn.tanh(h))


def _toy_params(seed):
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (8, 16)))
    params = jax_init_stage_params(ToyStage(), jax.random.PRNGKey(seed), jnp.asarray(x[:1]), 2)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), x


def _kernel_spec(spec):
    return lambda leaf: spec if leaf.ndim == 3 else JaxP("pipe")


TOY = [
    dict(name="data2_pipe2", spec=dict(data=2, pipe=2), microbatches=2, seed=0, specs=None),
    dict(name="pipe2_model2", spec=dict(pipe=2, model=2), microbatches=2, seed=2,
         specs=JaxP("pipe", None, "model")),
    dict(name="pipe2_fsdp2_tuple", spec=dict(fsdp=2, pipe=2), microbatches=2, seed=4,
         specs=JaxP("pipe", None, ("fsdp", "model"))),
]


def _jax_toy(case, params, x):
    """JAX's pipelined output and gradients on 4 devices, and the sequential
    oracle's."""
    mesh = JaxMeshSpec(**{"data": 1, **case["spec"]}).build(jax.devices()[:4])
    stage = ToyStage()
    stage_fn = lambda p, h: stage.apply({"params": p}, h)  # noqa: E731
    specs = None
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    if case["specs"] is not None:
        specs = jax.tree_util.tree_map(_kernel_spec(case["specs"]), jparams)
        jparams = jax.tree_util.tree_map(lambda a, s: jax.device_put(a, JaxNamedSharding(mesh, s)), jparams, specs)

    def loss_pipe(p):
        out = jax_pipeline_apply(stage_fn, p, jnp.asarray(x), mesh, n_microbatches=case["microbatches"],
                                 param_specs=specs)
        return jnp.mean(out ** 2), out

    def loss_seq(p):
        out = jax_sequential_stage_apply(stage_fn, p, jnp.asarray(x))
        return jnp.mean(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_pipe, has_aux=True))(jparams)
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(loss_seq, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                                                                      params))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return np.asarray(out), to_np(grads), np.asarray(ref), to_np(ref_grads)


SP = {
    # (mesh, impl, B, L, H, Hkv, D): tests/emulated/test_models.py's ring and ulysses gradient cases on 4 devices
    "ring": (dict(data=1, sequence=4), "ring", 1, 128, 2, 2, 32),
    "ulysses": (dict(data=2, sequence=2), "ulysses", 2, 128, 4, 4, 32),
}


def _sp_inputs(name):
    _, _, b, length, h, hkv, d = SP[name]
    return tuple(np.asarray(jax.random.normal(jax.random.PRNGKey(i), (b, length, n, d)))
                 for i, n in enumerate((h, hkv, hkv)))


def _jax_sp(name, q, k, v):
    spec, impl, *_ = SP[name]
    mesh = JaxMeshSpec(**spec).build(jax.devices()[:4])

    def sp_loss(q, k, v):
        return (jax_sequence_sharded_attention(q, k, v, mesh, causal=True, impl=impl) ** 2).mean()

    def dense_loss(q, k, v):
        return (jax_dot_product_attention(q, k, v, causal=True) ** 2).mean()

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    g_sp = jax.jit(jax.grad(sp_loss, argnums=(0, 1, 2)))(*args)
    g_dense = jax.jit(jax.grad(dense_loss, argnums=(0, 1, 2)))(*args)
    return [np.asarray(g) for g in g_sp], [np.asarray(g) for g in g_dense]


VIT = dict(n_layers=4)
VIT_SPEC = dict(pipe=2, model=2)


def _vit():
    cfg = JaxViTConfig.tiny(dtype=jnp.float32, **VIT)
    model = JaxPipelinedViT(cfg, n_stages=2, n_microbatches=2)
    images = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 32, 32, 3)))
    labels = np.arange(8, dtype=np.int32) % cfg.num_classes
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(images))
    return model, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), images, labels


def _jax_vit(model, params, images, labels):
    mesh = JaxMeshSpec(data=1, **VIT_SPEC).build(jax.devices()[:4])
    rules = jax_pipelined_vit_rules()
    from unionml_tpu.parallel import shard_pytree

    placed = shard_pytree(jax.tree_util.tree_map(jnp.asarray, params), rules.shardings(params, mesh))

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(images), mesh, rules)
        return optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), jnp.asarray(labels)).mean()

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(placed)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


GEN = dict(vocab_size=96, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128)
GEN_KW = dict(max_new_tokens=6, temperature=0.0, prompt_buckets=(8,))
PROMPTS = [[3, 5, 7, 9], [11, 2, 4]]


def _gen_tree():
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **GEN))
    params = module.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    return module, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _jax_generate(module, tree):
    return JaxGenerator(module, jax.tree_util.tree_map(jnp.asarray, tree), JaxGenerationConfig(**GEN_KW))(PROMPTS)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    toy = {case["name"]: _toy_params(case["seed"]) for case in TOY}
    sp = {name: _sp_inputs(name) for name in SP}
    vit_model, vit_params, images, labels = _vit()
    gen_module, gen_tree = _gen_tree()
    payload = {
        "toy": [dict(name=case["name"], spec=case["spec"], microbatches=case["microbatches"],
                     params=toy[case["name"]][0], x=toy[case["name"]][1],
                     specs=None if case["specs"] is None else
                     {owner: {"kernel": tuple(case["specs"]), "bias": ("pipe",)} for owner in ("Dense_0", "Dense_1")})
                for case in TOY],
        "sp": {name: (SP[name][0], SP[name][1], *sp[name]) for name in SP},
        "vit": {"config": VIT, "spec": VIT_SPEC, "tree": vit_params, "images": images, "labels": labels},
        "generate": {"spec": dict(pipe=2, model=2), "tree": gen_tree, "config": GEN, "kw": GEN_KW,
                     "prompts": PROMPTS},
    }
    world = World(4, "pipeline_rank", payload, tmp_path_factory.mktemp("pipeline"), timeout=300)
    jobs = {case["name"]: (lambda case=case: _jax_toy(case, *toy[case["name"]])) for case in TOY}
    jobs.update({f"sp/{name}": (lambda name=name: _jax_sp(name, *sp[name])) for name in SP})
    jobs["vit"] = lambda: _jax_vit(vit_model, vit_params, images, labels)
    jobs["generate"] = lambda: _jax_generate(gen_module, gen_tree)
    return toy, world, threaded(jobs, workers=2)


@pytest.fixture(scope="module")
def results(started):
    toy, world, refs = started
    return toy, world.results(), {k: f.result() for k, f in refs.items()}


def _flat(tree):
    return {_path_str(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rows(full, res):
    """The rows of ``full`` a rank holds (its batch axes' block)."""
    axes = tuple(a for a in ("data", "fsdp") if res["sizes"][a] > 1) or None
    return full[shard_slices(full.shape, P(axes), res["sizes"], res["coordinate"])]


@pytest.mark.parametrize("name", [case["name"] for case in TOY])
def test_pipeline_apply_matches_jax_and_sequential(results, name):
    """Each rank's output rows equal JAX's pipelined and sequential outputs,
    and its shards of every gradient (its stage's slice, its intra-stage
    shard) equal JAX's pipelined and sequential gradients, within 1e-5."""
    _, ranks, refs = results
    out, grads, ref, ref_grads = refs[name]
    np.testing.assert_allclose(out, ref, atol=1e-5)
    want, oracle = _flat(grads), _flat(ref_grads)
    for res in ranks:
        got = res[name]
        np.testing.assert_allclose(got["y"], _rows(out, got), atol=1e-5)
        flat = {f"{o}/{leaf}": g for o, leaves in got["grads"].items() for leaf, g in leaves.items()}
        assert set(flat) == set(want)
        for path, g in flat.items():
            index = shard_slices(want[path].shape, got["specs"][path], got["sizes"], got["coordinate"])
            np.testing.assert_allclose(g, want[path][index], atol=1e-5, err_msg=path)
            np.testing.assert_allclose(g, oracle[path][index], atol=1e-5, err_msg=path)


def test_pipeline_stage_dim_must_split_over_pipe():
    """A stage param spec whose leading dim is not over ``pipe`` is refused
    before any collective, with JAX's message."""

    class _Mesh:
        shape = {"data": 1, "fsdp": 1, "pipe": 2, "model": 1, "dcn_data": 1, "sequence": 1, "expert": 1}

    params = {"Dense_0": {"kernel": torch.zeros(1, 16, 32)}}
    with pytest.raises(ValueError, match="does not shard its leading \\(stage\\) dim over the 'pipe' axis"):
        pipeline_apply(stage_call(toy_stage(16)), params, torch.zeros(4, 16), _Mesh(), n_microbatches=2,
                       param_specs={"Dense_0": {"kernel": P(None, None, "model")}})


def test_two_axis_dim_gathers_minor_axis_first(results):
    """``P(None, ("fsdp", "model"))``: shard ``f * 2 + m`` sits at ``(f, m)``;
    the gather restores the whole array on every rank, and its backward
    gives each rank its shard of the cotangent (the ranks compute alike
    over ``model`` and sum over ``fsdp``: twice the cotangent)."""
    _, ranks, _ = results
    whole = np.arange(32, dtype=np.float32).reshape(4, 8)
    for res in ranks:
        back, grad, coordinate = res["two_axis"]
        np.testing.assert_array_equal(back, whole)
        block = coordinate["fsdp"] * 2 + coordinate["model"]
        np.testing.assert_array_equal(grad, 2 * whole[:, 2 * block:2 * block + 2])


@pytest.mark.parametrize("name", list(SP))
def test_sequence_parallel_gradients_match_jax(results, name):
    """``mean(out ** 2)`` through ring / ulysses attention: every rank's
    whole gradients of q, k and v equal JAX's sequence-parallel gradients
    and dense attention's within 2e-5 (the JAX tests' tolerance)."""
    _, ranks, refs = results
    g_sp, g_dense = refs[f"sp/{name}"]
    for res in ranks:
        _, *grads = res[name]
        for got, want, dense in zip(grads, g_sp, g_dense):
            np.testing.assert_allclose(got, want, atol=2e-5)
            np.testing.assert_allclose(got, dense, atol=2e-5)


def test_pipelined_vit_train_step_matches_jax(results):
    """One step of ``PipelinedViT`` at ``pipe=2, model=2``: the loss
    within 1e-5 relative, every rank's shard of every gradient within 1e-5
    of JAX's, and the params moved by the Adam step."""
    _, ranks, refs = results
    loss, grads = refs["vit"]
    want = _flat(grads)
    for res in ranks:
        got = res["vit"]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        flat = {}

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[f"{prefix}{k}"] = v

        walk(got["grads"], "")
        assert set(flat) == set(want)
        for path, g in flat.items():
            index = shard_slices(want[path].shape, got["specs"][path], got["sizes"], got["coordinate"])
            np.testing.assert_allclose(g, want[path][index], atol=1e-5, err_msg=path)
        assert got["specs"]["stages/layer_0/attn/q_proj/kernel"] == ("pipe", "fsdp", "model")
        assert got["moved"] > 0


def test_generator_over_a_pipe_axis_matches_jax(results):
    """Serving accepts a ``pipe`` axis as JAX does (replicated by the
    rules): greedy tokens at ``pipe=2, model=2`` equal JAX's unsharded
    ``Generator``'s on every rank."""
    _, ranks, refs = results
    for res in ranks:
        np.testing.assert_array_equal(np.asarray(res["generate"]), np.asarray(refs["generate"]))


def test_pipelined_vit_bridge_round_trips():
    """``pipelined_vit_from_jax`` takes JAX's ``PipelinedViT`` tree (stacked
    ``[n_stages, ...]`` stage leaves) as it is, and
    ``pipelined_vit_params_to_numpy`` gives it back leaf for leaf; a tree
    missing a leaf is refused, naming it."""
    from unionml_tpu_torch.models import ViTConfig, pipelined_vit_from_jax, pipelined_vit_params_to_numpy

    _, tree, _, _ = _vit()
    cfg = ViTConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **VIT)
    port = pipelined_vit_from_jax(tree, cfg, 2, device="cpu")
    assert port["stages"]["layer_0"]["attn"]["q_proj"]["kernel"].shape == (2, 128, 128)
    back, want = _flat(pipelined_vit_params_to_numpy(port)), _flat(tree)
    assert back.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(back[path], value, err_msg=path)
    del tree["head"]["head"]["bias"]
    with pytest.raises(ValueError, match="head.head.bias"):
        pipelined_vit_from_jax(tree, cfg, 2, device="cpu")
