"""The port's replica scheduler and replica set (``serving/replicas.py``)
against the JAX package's, on the CPU.

``tests/unit/test_replicas.py`` runs here against the port (see
``test_torch_serving_units.py``): least-loaded order, prefix affinity, the
hotspot fallback, full-fleet and deadline sheds and the stats aggregation,
over stub engines. Then the port's ``ReplicaScheduler`` and the JAX
package's decide the same order and head flag on the same seeded loads,
prompts, radix probes, breach and role flags and tenants; a pre-quantized
(int8) model replicates with its weights unchanged; the mesh path's
``dp_extent`` equals JAX's and a world of one builds one replica (the
multi-rank mesh path is in ``test_torch_fleet_mesh.py``); and the kernels'
launch counts stay exact under concurrent threads. Disaggregation and elasticity are in
``test_torch_disagg.py``.
"""

import copy
import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_serving_units import port_cases

torch.set_num_threads(2)

port_cases(globals(), "test_replicas.py")

from unionml_tpu_torch.serving.replicas import ReplicaScheduler as PortScheduler  # noqa: E402
from unionml_tpu_torch.serving.replicas import ReplicaSet as PortReplicaSet  # noqa: E402
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)



def _decisions(seed: int, n: int = 300):
    """Seeded routing decisions: loads (ints and token-weighted floats),
    prompts from a small vocabulary (so prefixes repeat), and optional radix
    probes, breach flags, role flags and tenants."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        replicas = int(rng.integers(1, 5))
        loads = [float(x) for x in rng.integers(0, 6, size=replicas) + rng.choice([0.0, 0.25, 3.5], size=replicas)]
        prompt = [int(t) for t in rng.integers(1, 4, size=int(rng.integers(1, 6)))]
        cached = [int(x) for x in rng.integers(0, 3, size=replicas) * 8] if rng.random() < 0.4 else None
        breaching = [bool(x) for x in rng.random(replicas) < 0.3] if rng.random() < 0.5 else None
        deprioritized = [bool(x) for x in rng.random(replicas) < 0.3] if rng.random() < 0.3 else None
        tenant = str(rng.choice(["a", "b", "c"])) if rng.random() < 0.5 else None
        yield replicas, loads, prompt, cached, breaching, deprioritized, tenant, int(rng.integers(0, replicas))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scheduler_decides_as_the_jax_scheduler(seed):
    """Both schedulers, fed the same decisions and notes (and resized as the
    fleet is), return the same order and head flag every time and end with
    the same telemetry."""
    from unionml_tpu.serving.replicas import ReplicaScheduler as JaxScheduler

    kw = dict(affinity_tokens=2, affinity_margin=1, affinity_capacity=8, tenant_affinity_capacity=2)
    port, jax_sched = PortScheduler(4, **kw), JaxScheduler(4, **kw)
    for replicas, loads, prompt, cached, breaching, deprioritized, tenant, noted in _decisions(seed):
        for sched in (port, jax_sched):
            sched.resize(replicas)
        got = port.order(loads, prompt, cached, breaching, deprioritized, tenant=tenant)
        want = jax_sched.order(loads, prompt, cached, breaching, deprioritized, tenant=tenant)
        assert got == want
        head = got[0][0] == noted
        for sched in (port, jax_sched):
            sched.note(noted, prompt, affinity=got[1] if head else False, tenant=tenant)
    assert port.stats() == jax_sched.stats()


def test_scheduler_validation_matches_jax():
    from unionml_tpu.serving.replicas import ReplicaScheduler as JaxScheduler

    for args, kw in (((0,), {}), ((2,), {"affinity_tokens": -1}), ((2,), {"affinity_capacity": 0}),
                     ((2,), {"tenant_affinity_capacity": 0})):
        for cls in (PortScheduler, JaxScheduler):
            with pytest.raises(ValueError):
                cls(*args, **kw)


def test_mesh_path_refuses_naming_its_item():
    """The mesh path is ported: ``dp_extent`` reads a mesh's batch axes as
    the JAX package's does, a world of one slices to itself, and
    ``ReplicaSet.build`` over it (or with rules and no mesh) builds one
    replica, as JAX's does over a one-device mesh."""
    import types

    import torch.distributed as dist

    from tests.test_torch_serving_units import tiny_llama
    from unionml_tpu.serving.replicas import dp_extent as jax_dp_extent
    from unionml_tpu_torch.models import GenerationConfig, llama_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.serving.replicas import dp_extent, slice_mesh

    assert dp_extent(None) == jax_dp_extent(None) == 1
    for shape in ({"data": 2, "fsdp": 3, "model": 2}, {"dcn_data": 2, "data": 1}, {"model": 4}):
        fake = types.SimpleNamespace(shape=shape)
        assert dp_extent(fake) == jax_dp_extent(fake)
    try:
        mesh = MeshSpec(data=1).build(device="cpu")
        assert slice_mesh(mesh) == [mesh]
        fleet = PortReplicaSet.build(tiny_llama(96, 0), GenerationConfig(), mesh=mesh,
                                     partition_rules=llama_partition_rules(), autoscale=False)
        try:
            assert fleet.replicas == 1 and fleet.batchers[0].gen.mesh is mesh and fleet.spare_capacity() == 0
        finally:
            fleet.close()
    finally:
        dist.destroy_process_group()
    fleet = PortReplicaSet.build(tiny_llama(96, 0), GenerationConfig(), partition_rules=[], autoscale=False,
                                 devices=["cpu"])
    try:
        assert fleet.replicas == 1
    finally:
        fleet.close()


def _int8_model():
    from unionml_tpu_torch.models import Llama, LlamaConfig

    # wide enough that quantize="int8" (min_size 65536) takes q/o, the MLP and the head
    config = LlamaConfig.tiny(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512,
                              dtype=torch.float32, param_dtype=torch.float32)
    return Llama(config, device="cpu", seed=3)


def _state(model):
    return {name: t.detach().clone() for name, t in model.state_dict().items()}


def test_int8_generator_replicates_with_identical_weights():
    """A fleet over a pre-quantized Generator shares its int8 module as it
    is (no second quantization) and streams what the original streams; the
    copy a replica on another device gets (``deepcopy`` then ``.to``) holds
    the same int8 values and scales bit for bit, and a Generator over it
    leaves them so. The JAX package dequantizes and re-quantizes instead,
    an exact round trip on the same weights: skipping it changes nothing."""
    import jax
    from unionml_tpu.ops.quant import dequantize_tree, quantize_params

    from unionml_tpu_torch.models import GenerationConfig, Generator, llama_params_to_numpy
    from unionml_tpu_torch.serving import ContinuousBatcher

    model = _int8_model()
    cfg = GenerationConfig(max_new_tokens=6, temperature=0.0, prompt_buckets=(16,))
    float_tree = llama_params_to_numpy(model)
    gen = Generator(model, cfg, device="cpu", quantize="int8")
    before = _state(model)
    assert any(t.dtype == torch.int8 for t in before.values())
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    solo = [gen([p])[0].tolist() for p in prompts]
    fleet = PortReplicaSet.from_generator(gen, replicas=2, slots=2, decode_chunk=3)
    try:
        assert all(b.gen.model is model and b.gen.quantize == "int8" for b in fleet.batchers)
        streams = [[int(t) for c in fleet.submit(p) for t in np.asarray(c).ravel()] for p in prompts]
    finally:
        fleet.close()
    assert streams == solo
    after = _state(model)
    assert after.keys() == before.keys() and all(torch.equal(after[k], before[k]) for k in before)

    clone = copy.deepcopy(model).to("cpu")
    assert clone is not model
    Generator(clone, cfg, device="cpu", quantize="int8")
    cloned = _state(clone)
    assert all(torch.equal(cloned[k], before[k]) for k in before)
    engine = ContinuousBatcher._single(Generator(clone, cfg, device="cpu", quantize="int8"), slots=2)
    try:
        assert [[int(t) for c in engine.submit(p) for t in np.asarray(c).ravel()] for p in prompts] == solo
    finally:
        engine.close()

    # the JAX package's per-replica round trip reproduces its int8 planes exactly
    q = quantize_params(jax.tree_util.tree_map(np.asarray, float_tree))
    again = quantize_params(dequantize_tree(q, dtype="float32"))
    leaves, leaves_again = jax.tree_util.tree_leaves(q), jax.tree_util.tree_leaves(again)
    assert len(leaves) == len(leaves_again)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(leaves, leaves_again))


def test_launch_counts_are_exact_across_threads():
    """The kernel wrappers' counters, bumped from many threads at once (two
    engines of one fleet launch from threads of their own), lose no count."""
    from unionml_tpu_torch._build import count_launch
    from unionml_tpu_torch.ops.paged_attention import paged_decode_attention

    saved = paged_decode_attention.launches, dict(paged_decode_attention.int8_route_launches)
    paged_decode_attention.launches = 0
    route = next(iter(saved[1]))
    paged_decode_attention.int8_route_launches[route] = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can: a lost update shows
    try:
        def bump():
            for _ in range(20_000):
                count_launch(paged_decode_attention)
                count_launch(paged_decode_attention, "int8_route_launches", route)

        threads = [threading.Thread(target=bump) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert paged_decode_attention.launches == 16 * 20_000
        assert paged_decode_attention.int8_route_launches[route] == 16 * 20_000
    finally:
        sys.setswitchinterval(interval)
        paged_decode_attention.launches = saved[0]
        paged_decode_attention.int8_route_launches.update(saved[1])
