"""The port's multi-host fleet coordinator (``serving/cluster.py``) in one
process, held against the JAX package on the CPU.

``tests/unit/test_cluster.py`` runs here against the port, every case (see
``test_torch_serving_units.py``): the block-native export payload and its
``npz`` wire round trip, a coordinator over a local and a remote host (a
real ``WorkerAgent`` control server on loopback), the cross-host
prefill/decode handoff, fleet-global prefix routing, a worker's death routed
around, every host dead, ``scale_to`` over two ``ReplicaSet`` hosts with
streams in flight, the shed mapping, an expired deadline and host-role
validation. The engines serve the unit file's tiny f32 Llama on weights
carried from its JAX init, and every stream is held against the JAX
package's ``Generator`` on those weights. The port's ``ReplicaSet.build``
takes the model and its config, so the unit file's ``build(module, params,
cfg, ...)`` calls drop ``params``.

Then the wire between the packages: an f32 handoff serialized by each is
read back by the other, array for array, and the port's decode engine
continues JAX's exported prefill token for token; a bf16 payload makes a
port-to-port round trip bit for bit (numpy has no bfloat16: its raw 16 bits
cross, the dtype in the metadata).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_continuous import _models
from tests.test_torch_serving_units import generator, port_cases

torch.set_num_threads(2)

port_cases(globals(), "test_cluster.py", subs=((r"ReplicaSet\.build\((\s*)module, params, ", r"ReplicaSet.build(\1module, "),))
Generator = generator  # noqa: F811

SHAPE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)


@pytest.fixture(scope="module")
def pair():
    """The unit file's JAX init (``PRNGKey(1)``) and a port model on its weights."""
    return _models(SHAPE, seed=1)


@pytest.fixture(scope="module")
def tiny(pair):  # noqa: F811
    return pair[2], None


_JAX_GENERATORS = {}


def _jax_expected(pair, cfg, prompts):
    """Each prompt's greedy tokens from the JAX package's ``Generator`` on
    the carried weights, under ``cfg``'s knobs."""
    from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator

    key = (cfg.max_new_tokens, cfg.temperature, tuple(cfg.prompt_buckets))
    if key not in _JAX_GENERATORS:
        jcfg = JaxGenerationConfig(max_new_tokens=key[0], temperature=key[1], prompt_buckets=key[2])
        _JAX_GENERATORS[key] = JaxGenerator(pair[0], pair[1], jcfg)
    gen = _JAX_GENERATORS[key]
    return [list(map(int, gen([p])[0])) for p in prompts]


@pytest.fixture(autouse=True)
def _held_to_jax(pair, monkeypatch):
    """The unit cases' oracle, ``_expected``, is JAX's Generator here."""
    monkeypatch.setitem(globals(), "_expected", lambda module, params, cfg, prompts: _jax_expected(pair, cfg, prompts))


# ----------------------------------------------------------------- the wire


def _jax_export(pair, prompt, cfg_kw):
    from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator
    from unionml_tpu.serving import ContinuousBatcher as JaxBatcher

    engine = JaxBatcher(JaxGenerator(pair[0], pair[1], JaxGenerationConfig(**cfg_kw)), role="prefill",
                        slots=2, decode_chunk=4, block_size=8, pool_blocks=64)
    try:
        stream = engine.submit(prompt, export_handoff=True)
        first = [int(t) for c in stream for t in np.asarray(c).ravel()]
        return first, stream.handoff
    finally:
        engine.close(wait=False)


def _port_export(model, prompt, cfg_kw):
    from unionml_tpu_torch.models import GenerationConfig, Generator as PortGenerator
    from unionml_tpu_torch.serving import ContinuousBatcher as PortBatcher

    engine = PortBatcher(PortGenerator(model, GenerationConfig(**cfg_kw), device="cpu"), role="prefill",
                         slots=2, decode_chunk=4, block_size=8, pool_blocks=64)
    try:
        stream = engine.submit(prompt, export_handoff=True)
        first = [int(t) for c in stream for t in np.asarray(c).ravel()]
        return first, stream.handoff
    finally:
        engine.close(wait=False)


CFG_KW = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))


def test_f32_handoff_crosses_between_the_packages(pair):
    """An f32 payload serialized by either package is read back by the
    other with every array equal and the same metadata; the port's decode
    engine adopting JAX's payload continues it as JAX's sequential run."""
    from unionml_tpu.serving.cluster import deserialize_handoff as jax_read, serialize_handoff as jax_write
    from unionml_tpu_torch.models import GenerationConfig
    from unionml_tpu_torch.serving import ContinuousBatcher as PortBatcher
    from unionml_tpu_torch.serving.cluster import deserialize_handoff, serialize_handoff

    prompt = PROMPTS[1]
    jax_first, jax_payload = _jax_export(pair, prompt, CFG_KW)
    port_first, port_payload = _port_export(pair[2], prompt, CFG_KW)
    assert jax_first == port_first
    read_by_port = deserialize_handoff(jax_write(jax_payload))
    read_by_jax = jax_read(serialize_handoff(port_payload))
    for read, sent in ((read_by_port, jax_payload), (read_by_jax, port_payload)):
        for key in ("prompt", "first", "lengths", "max_new", "produced", "echo", "block_size", "grammar"):
            assert read[key] == sent[key], key
        assert len(read["pages"]) == len(sent["pages"])
        for got, want in zip(read["pages"], sent["pages"]):
            assert sorted(got) == sorted(want)
            for name in want:
                np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))
    # the same pages, within the f32 twins' agreement
    for got, want in zip(port_payload["pages"], jax_payload["pages"]):
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=1e-5)
    engine = PortBatcher(generator(pair[2], None, GenerationConfig(**CFG_KW)), role="decode",
                         slots=2, decode_chunk=4, block_size=8, pool_blocks=64)
    try:
        rest = _drain(engine.import_handoff(read_by_port))
    finally:
        engine.close(wait=False)
    assert jax_first + rest == _jax_expected(pair, GenerationConfig(**CFG_KW), [prompt])[0]


def test_bf16_handoff_round_trips_bit_for_bit(pair):
    """A bf16 engine's payload crosses the port's wire as raw 16 bits and
    comes back equal bit for bit, as bf16; the importing engine decodes on
    to the same tokens as one bf16 engine serving the request."""
    import dataclasses

    from unionml_tpu_torch.models import GenerationConfig, Llama
    from unionml_tpu_torch.serving import ContinuousBatcher as PortBatcher
    from unionml_tpu_torch.serving.cluster import deserialize_handoff, serialize_handoff

    model = Llama(dataclasses.replace(pair[2].config, dtype=torch.bfloat16, param_dtype=torch.bfloat16), device="cpu")
    model.load_state_dict({k: v.to(torch.bfloat16) for k, v in pair[2].state_dict().items()})
    prompt = PROMPTS[0]
    first, payload = _port_export(model, prompt, CFG_KW)
    assert payload["pages"][0]["k"].dtype == torch.bfloat16
    back = deserialize_handoff(serialize_handoff(payload))
    for got, want in zip(back["pages"], payload["pages"]):
        for name in want:
            assert got[name].dtype == want[name].dtype
            assert torch.equal(got[name].view(torch.int16), want[name].view(torch.int16)), name
    engines = [PortBatcher(generator(model, None, GenerationConfig(**CFG_KW)), role=role, slots=2, decode_chunk=4,
                           block_size=8, pool_blocks=64) for role in ("decode", None)]
    try:
        rest = _drain(engines[0].import_handoff(back))
        whole = _drain(engines[1].submit(prompt))
    finally:
        for engine in engines:
            engine.close(wait=False)
    assert first + rest == whole
