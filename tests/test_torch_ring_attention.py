"""Ring and Ulysses attention (``unionml_tpu_torch/ops/ring_attention.py``)
against the JAX package's, on the CPU.

One world of 4 gloo ranks (``tests/torch_mesh_ranks.py``) runs the port's
``sequence_sharded_attention`` over a ``sequence=4`` mesh on seeded numpy
``[B, L, H, D]`` inputs: ring and ulysses, with and without grouped-query
K/V, causal and not. Each rank's gathered output is held, in f32 within
1e-5, to JAX's ``sequence_sharded_attention`` under ``shard_map`` on 4 of
the emulated devices, and to plain attention (the port's
``dot_product_attention`` on the whole sequence).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_mesh_ranks import World, threaded
from unionml_tpu.ops.ring_attention import sequence_sharded_attention as jax_sequence_sharded_attention
from unionml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from unionml_tpu_torch.ops.attention import dot_product_attention

torch.set_num_threads(2)

CASES = list(itertools.product(["ring", "ulysses"], [8, 2], [True, False]))  # impl, KV heads, causal
B, L, H, D = 2, 16, 8, 8


def _inputs(n_kv: int, seed: int):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, L, H, D).astype(np.float32)
    k = rng.randn(B, L, n_kv, D).astype(np.float32)
    v = rng.randn(B, L, n_kv, D).astype(np.float32)
    return q, k, v


def _jax_reference(case, q, k, v):
    impl, _, causal = case
    mesh = JaxMeshSpec(data=1, sequence=4).build(jax.devices()[:4])
    return np.asarray(jax_sequence_sharded_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh,
                                                     causal=causal, impl=impl))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, the ranks' results, and JAX's outputs (futures) computed
    here while the ranks work."""
    inputs = {case: _inputs(case[1], i) for i, case in enumerate(CASES)}
    world = World(4, "ring_rank", {"inputs": inputs}, tmp_path_factory.mktemp("ring"))
    refs = threaded({case: functools.partial(_jax_reference, case, *inputs[case]) for case in CASES})
    return inputs, world.results(), refs


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-kv{c[1]}-{'causal' if c[2] else 'full'}")
def test_sequence_parallel_attention_matches_jax_and_plain(world, case):
    inputs, results, refs = world
    _, _, causal = case
    q, k, v = inputs[case]
    ref = refs[case].result()
    plain = dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal).numpy()
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res[case], ref, atol=1e-5, rtol=1e-5, err_msg=f"rank {rank} vs JAX")
        np.testing.assert_allclose(res[case], plain, atol=1e-5, rtol=1e-5, err_msg=f"rank {rank} vs plain")
