"""Training over a mesh (``fit``/``evaluate`` with ``TrainerConfig(mesh=...)``)
in the port against the JAX package's ``fit`` on its emulated CPU mesh.

One world of 4 gloo ranks (``tests/torch_mesh_ranks.py``) trains a tiny f32
LoRA Llama from the same weights (carried by ``llama_from_jax``) on the same
numpy windows as JAX ``fit`` does with the same ``MeshSpec`` on 4 of its 8
devices, with ``llama_partition_rules()`` and a ``fsdp_min_weight_size`` that
puts the kernels under FSDP:

- ``data=2, fsdp=2``: the chunked loss with a loss mask whose count differs
  between ranks, a partial final batch of 6 rows (it does not split over 4
  ranks: every rank computes all of it, as JAX places it replicated), and
  ``evaluate`` on the trained state;
- ``data=2, model=2``: the plain masked loss with ``grad_accum_steps=2``
  (each rank's rows of each microbatch), checkpoints of each rank's shards
  and a resume from them;
- ``fsdp=2, model=2``: the chunked loss, unmasked, with ``device_data``;
- ``data=2, sequence=2``: the model's attention ``"ring"``, each rank
  training on its block of positions (JAX trains the same global batch on
  the same mesh, its sequence axis replicated);
- ``data=4`` with ``shard_batch_by_process``: each of the 4 processes
  slices its rows of every global batch itself, and all drop the short
  final batch (JAX, one process, trains the same batches unsliced: its
  ``index_batches`` drops nothing there, so its schedule is cut to the
  full batches);

then BERT fine-tune steps under ``bert_partition_rules()`` at ``data=2,
model=2``, ViT steps under ``vit_partition_rules()`` at ``data=2,
fsdp=2``, and MoE steps under ``moe_partition_rules()`` at ``data=2,
expert=2`` with tokens dropped at capacity. Each rank's loss history equals JAX's (1e-5
relative), and each rank's trained LoRA shards (BERT: every leaf) equal
JAX's trained leaves cut to that rank's coordinate (stated tolerances);
the frozen base kernels do not move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax.training import train_state

from tests.torch_mesh_ranks import World, threaded
from unionml_tpu import TrainerConfig as JaxTrainerConfig, make_train_step as jax_make_train_step
from unionml_tpu.models import BertConfig as JaxBertConfig, BertEncoder as JaxBertEncoder
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models import ViT as JaxViT, ViTConfig as JaxViTConfig
from unionml_tpu.models import bert_partition_rules as jax_bert_rules, llama_partition_rules as jax_llama_rules
from unionml_tpu.models import vit_partition_rules as jax_vit_rules
from unionml_tpu.models.bert import classification_loss as jax_classification_loss
from unionml_tpu.models.llama import causal_lm_loss as jax_causal_lm_loss
from unionml_tpu.models.llama import chunked_causal_lm_loss as jax_chunked_loss
from unionml_tpu.models.llama import lora_param_labels as jax_lora_param_labels
from unionml_tpu.models.moe import MoEConfig as JaxMoEConfig, MoETransformer as JaxMoETransformer
from unionml_tpu.models.moe import moe_lm_loss as jax_moe_lm_loss, moe_partition_rules as jax_moe_rules
from unionml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from unionml_tpu.parallel.sharding import _path_str
from unionml_tpu.train import evaluate as jax_evaluate, fit as jax_fit
from unionml_tpu_torch.parallel.sharding import shard_slices

LLAMA = dict(vocab_size=96, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128)
#: both sides step by SGD (the adapters only, for the LoRA Llama): an update linear in the gradient, where
#: Adam would turn the f32 rounding of a near-zero gradient into a whole step
LR, SEQ, MIN_WEIGHT = 0.3, 10, 1024


class _On4(JaxMeshSpec):
    """A JAX ``MeshSpec`` built over the first 4 emulated devices: the same
    mesh as the 4 ranks'."""

    def build(self, devices=None):
        return super().build(jax.devices()[:4] if devices is None else devices)


def _llama_tree():
    """Flax params with nonzero ``lora_b`` (at zero, step one leaves every
    ``lora_a`` gradient at zero and half the adapter math untested)."""
    module = JaxLlama(JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32, param_dtype=jnp.float32, **LLAMA))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.RandomState(0)
    return module, jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape) * 0.05).astype(np.float32)
        if "lora_b" in jax.tree_util.keystr(path) else np.asarray(a, np.float32),
        params,
    )


def _windows(n, seed=1):
    return np.random.RandomState(seed).randint(0, LLAMA["vocab_size"], size=(n, SEQ)).astype(np.int32)


def _uneven_mask(n, seed=2):
    """A loss mask whose per-row counts differ a lot (some rows hold one
    target), so each rank's count differs from the others'."""
    rng = np.random.RandomState(seed)
    keep = rng.randint(1, SEQ, size=n)
    return (np.arange(SEQ)[None, :] < keep[:, None] + 1).astype(np.int32)


CASES = [
    dict(name="data2_fsdp2", spec=dict(data=2, fsdp=2), loss="chunked", evaluate=True,
         data=lambda: [_windows(22), _uneven_mask(22)],
         trainer=dict(epochs=1, batch_size=8, seed=3, drop_remainder=False)),
    dict(name="data2_model2", spec=dict(data=2, model=2), loss="plain", accum=2, checkpoint=True,
         data=lambda: [_windows(16, 4), _uneven_mask(16, 5)], trainer=dict(epochs=2, batch_size=8, seed=4)),
    dict(name="fsdp2_model2", spec=dict(fsdp=2, model=2), loss="chunked", data=lambda: _windows(16, 6),
         trainer=dict(epochs=1, batch_size=4, seed=5, device_data=True)),
    dict(name="data2_sequence2", spec=dict(data=2, sequence=2), loss="plain", model=dict(attention_impl="ring"),
         data=lambda: [_windows(8, 7), _uneven_mask(8, 8)], trainer=dict(epochs=1, batch_size=4, seed=6)),
    dict(name="data4_by_process", spec=dict(data=4), loss="chunked", data=lambda: [_windows(18, 9), _uneven_mask(18, 9)],
         trainer=dict(epochs=1, batch_size=8, seed=7, drop_remainder=False, shard_batch_by_process=True)),
]
BERT = dict(vocab_size=128, dim=64, n_layers=2, n_heads=4, hidden_dim=128, max_seq_len=16)
BERT_SPEC = dict(data=2, model=2)
VIT = dict(n_layers=2)
VIT_SPEC = dict(data=2, fsdp=2)
#: JAX's expert-parallel layout (``tests/emulated/test_moe.py``) on 4 ranks, at the default capacity factor
#: 1.25 (tokens drop) and aux loss weight 0.01
MOE = dict(n_experts=4, capacity_factor=1.25, aux_loss_weight=0.01)
MOE_SPEC = dict(data=2, expert=2)


def _bert():
    module = JaxBertEncoder(JaxBertConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **BERT))
    rng = np.random.RandomState(9)
    tokens = rng.randint(0, BERT["vocab_size"], size=(16, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < rng.randint(3, 13, size=16)[:, None]).astype(np.int32)
    labels = rng.randint(0, 2, size=16).astype(np.int32)
    params = module.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    return module, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), [tokens, mask, labels]


def _moe():
    module = JaxMoETransformer(JaxMoEConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **MOE))
    tokens = np.random.RandomState(11).randint(0, module.config.vocab_size, size=(16, 12)).astype(np.int32)
    params = module.init(jax.random.PRNGKey(3), jnp.asarray(tokens[:1]))["params"]
    return module, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), tokens


def _jax_moe_fit(module, tree, tokens):
    state = train_state.TrainState.create(apply_fn=module.apply, params=jax.tree_util.tree_map(jnp.asarray, tree),
                                          tx=optax.sgd(LR))
    step = jax_make_train_step(lambda p, b: jax_moe_lm_loss(module, p, b))
    cfg = JaxTrainerConfig(mesh=_On4(**MOE_SPEC), partition_rules=jax_moe_rules(), epochs=1, batch_size=8, seed=3,
                           log_every_steps=1)
    return jax_fit(state, step, tokens, cfg)


def _jax_llama_fit(module, tree, case):
    def apply(p, t):
        return module.apply({"params": p}, t)

    loss = (lambda p, b: jax_chunked_loss(module, p, b, chunk_size=4)) if case["loss"] == "chunked" \
        else (lambda p, b: jax_causal_lm_loss(apply, p, b))
    tx = optax.multi_transform({"lora": optax.sgd(LR), "frozen": optax.set_to_zero()}, jax_lora_param_labels)
    state = train_state.TrainState.create(apply_fn=module.apply, params=jax.tree_util.tree_map(jnp.asarray, tree),
                                          tx=tx)
    trainer = dict(case["trainer"])
    if trainer.get("shard_batch_by_process"):  # the port's 4 processes drop the short final batch
        trainer["drop_remainder"] = True
    mesh = _On4(**case["spec"])
    cfg = JaxTrainerConfig(mesh=mesh, partition_rules=jax_llama_rules(), fsdp_min_weight_size=MIN_WEIGHT,
                           log_every_steps=1, **trainer)
    result = jax_fit(state, jax_make_train_step(loss, grad_accum_steps=case.get("accum", 1)), case["data"](), cfg)
    metrics = None
    if case.get("evaluate"):
        metrics = jax_evaluate(result.state, lambda s, b: {"loss": jax_causal_lm_loss(apply, s.params, b)},
                               case["data"](), batch_size=6, mesh=mesh, partition_rules=jax_llama_rules(),
                               fsdp_min_weight_size=MIN_WEIGHT)
    return result, metrics


def _jax_bert_fit(module, tree, data):
    def apply(p, t, m=None):
        return module.apply({"params": p}, t, m)

    state = train_state.TrainState.create(apply_fn=module.apply, params=jax.tree_util.tree_map(jnp.asarray, tree),
                                          tx=optax.sgd(LR))
    step = jax_make_train_step(lambda p, b: jax_classification_loss(apply, p, b), has_aux=True)
    cfg = JaxTrainerConfig(mesh=_On4(**BERT_SPEC), partition_rules=jax_bert_rules(), epochs=1, batch_size=8, seed=3,
                           log_every_steps=1)
    return jax_fit(state, step, data, cfg)


def _vit():
    module = JaxViT(JaxViTConfig.tiny(dtype=jnp.float32, **VIT))
    rng = np.random.RandomState(10)
    images = rng.randn(8, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, 10, size=8).astype(np.int32)
    params = module.init(jax.random.PRNGKey(2), jnp.asarray(images))["params"]
    return module, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params), [images, labels]


def _jax_vit_fit(module, tree, data):
    state = train_state.TrainState.create(apply_fn=module.apply, params=jax.tree_util.tree_map(jnp.asarray, tree),
                                          tx=optax.sgd(LR))
    step = jax_make_train_step(lambda p, b: jax_classification_loss(lambda pp, x: module.apply({"params": pp}, x),
                                                                    p, b), has_aux=True)
    cfg = JaxTrainerConfig(mesh=_On4(**VIT_SPEC), partition_rules=jax_vit_rules(), fsdp_min_weight_size=MIN_WEIGHT,
                           epochs=1, batch_size=4, seed=3, log_every_steps=1)
    return jax_fit(state, step, data, cfg)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The world of 4 ranks and JAX's runs, started together: the parent
    computes the references on threads while the ranks train."""
    module, tree = _llama_tree()
    bert_module, bert_tree, bert_data = _bert()
    vit_module, vit_tree, vit_data = _vit()
    moe_module, moe_tree, moe_data = _moe()
    payload = {
        "tree": tree, "config": dict(LLAMA, lora_rank=4), "lr": LR, "min_weight": MIN_WEIGHT,
        "checkpoints": str(tmp_path_factory.mktemp("checkpoints")),
        "cases": [{k: (v() if k == "data" else v) for k, v in case.items()} for case in CASES],
        "bert": {"tree": bert_tree, "config": BERT, "spec": BERT_SPEC, "data": bert_data,
                 "trainer": dict(epochs=1, batch_size=8, seed=3)},
        "vit": {"tree": vit_tree, "config": VIT, "spec": VIT_SPEC, "data": vit_data,
                "trainer": dict(epochs=1, batch_size=4, seed=3, fsdp_min_weight_size=MIN_WEIGHT)},
        "moe": {"tree": moe_tree, "config": MOE, "spec": MOE_SPEC, "data": moe_data,
                "trainer": dict(epochs=1, batch_size=8, seed=3)},
    }
    world = World(4, "train_rank", payload, tmp_path_factory.mktemp("train"), timeout=300)
    jobs = {case["name"]: (lambda case=case: _jax_llama_fit(module, tree, case)) for case in CASES}
    jobs["bert"] = lambda: _jax_bert_fit(bert_module, bert_tree, bert_data)
    jobs["vit"] = lambda: _jax_vit_fit(vit_module, vit_tree, vit_data)
    jobs["moe"] = lambda: _jax_moe_fit(moe_module, moe_tree, moe_data)
    return tree, world, threaded(jobs, workers=2)


@pytest.fixture(scope="module")
def results(started):
    tree, world, refs = started
    return tree, world.results(), {k: f.result() for k, f in refs.items()}


def _flat(tree):
    return {_path_str(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _hold_shards(res, want, names, atol, mean_atol=None):
    """Each rank's shards equal JAX's leaves cut to its coordinate."""
    diffs = []
    for name in names:
        full = want[name.replace(".", "/")]
        index = shard_slices(full.shape, res["specs"][name], res["sizes"], res["coordinate"])
        diffs.append(np.abs(res["lora" if "lora" in res else "params"][name] - full[index]).ravel())
    diffs = np.concatenate(diffs)
    assert diffs.max() <= atol, diffs.max()
    if mean_atol is not None:
        assert diffs.mean() <= mean_atol, diffs.mean()


@pytest.mark.parametrize("name", [case["name"] for case in CASES])
def test_fit_over_a_mesh_matches_jax_fit(results, name):
    """Loss history: 1e-5 relative on every rank (f32; the sides sum in
    other orders and over other shards). Trained adapters (SGD, lr 0.3):
    1e-5 absolute for any entry, 1e-6 on the mean."""
    tree, ranks, refs = results
    ref, _ = refs[name]
    want_losses = [h["loss"] for h in ref.history]
    want = _flat(ref.state.params)
    for res in ranks:
        got = res[name]
        assert got["steps"] == ref.steps
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        assert got["frozen"], "a frozen base kernel moved"
        _hold_shards(got, want, sorted(got["lora"]), atol=1e-5, mean_atol=1e-6)
        if name == "data2_fsdp2":  # the adapters' shards really are FSDP's
            assert got["specs"]["layer_0.attn.q_proj.lora_a"] == ("fsdp", None)
            assert got["lora"]["layer_0.attn.q_proj.lora_a"].shape[0] == LLAMA["dim"] // 2


def test_evaluate_over_a_mesh_matches_jax(results):
    """``evaluate`` on the trained, placed state: JAX's weighted mean over
    4 batches (6, 6, 6, 4 rows; the last does not split over 4 ranks)."""
    _, ranks, refs = results
    _, metrics = refs["data2_fsdp2"]
    for res in ranks:
        assert res["data2_fsdp2"]["evaluate"]["loss"] == pytest.approx(metrics["loss"], rel=1e-5)


def test_checkpoints_hold_each_ranks_shards(results):
    """Over a mesh each rank saves its own shards (``step_<N>.rank<r>.pt``,
    the newest 3 kept) and resumes from them: a resumed run at the last step
    runs nothing and holds the trained adapters bit for bit."""
    _, ranks, _ = results
    for res in ranks:
        steps, equal, files = res["data2_model2"]["resumed"]
        assert steps == 0 and equal
        assert files == sorted(f"step_{n}.rank{r}.pt" for n in (2, 4) for r in range(4))


def test_samples_per_sec_per_chip_divides_by_the_world(results):
    _, ranks, _ = results
    for res in ranks:
        total, per_chip = res["data2_model2"]["per_chip"]
        assert per_chip == pytest.approx(total / 4)


@pytest.mark.parametrize("name", ["bert", "vit"])
def test_encoder_steps_under_their_partition_rules(results, name):
    """Two SGD steps (lr 0.3) of BERT fine-tuning at ``data=2, model=2``
    (ragged attention masks) under ``bert_partition_rules()``, and of ViT
    at ``data=2, fsdp=2`` under ``vit_partition_rules()`` (the patch kernel
    and the head gathered over ``fsdp``): loss and accuracy per step within
    1e-5, every leaf of every rank within 1e-5 of JAX's."""
    _, ranks, refs = results
    ref = refs[name]
    want = _flat(ref.state.params)
    for res in ranks:
        got = res[name]
        assert [h["step"] for h in got["history"]] == [h["step"] for h in ref.history]
        for a, b in zip(got["history"], ref.history):
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
            assert a["accuracy"] == pytest.approx(b["accuracy"], abs=1e-6)
        _hold_shards(got, want, sorted(got["params"]), atol=1e-5)
        assert got["specs"]["layer_0.attn.q_proj.kernel"] == ("fsdp", "model")
        if name == "vit":
            assert got["specs"]["embed.patch_embed.kernel"] == (None, None, None, "fsdp")


def test_moe_fit_over_expert_and_data_axes_matches_jax(results):
    """MoE ``fit`` at ``data=2, expert=2`` (capacity factor 1.25, aux loss
    weight 0.01), two SGD steps (lr 0.3) of every leaf against JAX's
    ``fit`` on the same mesh: losses within 1e-5 relative, each rank's
    shard of every leaf within 1e-5. The experts' share of each rank takes
    the replicated tokens and gates through f, and the capacity, slots and
    aux loss are the global batch's."""
    _, ranks, refs = results
    ref = refs["moe"]
    want = _flat(ref.state.params)
    for res in ranks:
        got = res["moe"]
        np.testing.assert_allclose(got["losses"], [h["loss"] for h in ref.history], rtol=1e-5)
        _hold_shards(got, want, sorted(got["params"]), atol=1e-5)
        assert got["specs"]["layer_0.moe.experts.wi.kernel"][0] == "expert"
        assert got["params"]["layer_0.moe.experts.wi.kernel"].shape[0] == MOE["n_experts"] // 2


def test_model_train_takes_a_mesh():
    """``Model.train`` with ``TrainerConfig(mesh=MeshSpec(data=1),
    partition_rules=llama_partition_rules())`` (and an evaluator over the
    same mesh) in a world of one process: the history and metrics of the
    same app without a mesh, bit for bit."""
    import torch
    import torch.distributed as dist

    import unionml_tpu_torch
    from unionml_tpu_torch import Llama, LlamaConfig, TrainerConfig, TrainState, make_train_step
    from unionml_tpu_torch.models import causal_lm_loss, llama_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec

    def app(**mesh):
        cfg = LlamaConfig.tiny(dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64, vocab_size=32,
                               dtype=torch.float32, param_dtype=torch.float32)
        dataset = unionml_tpu_torch.Dataset(name="tokens")
        model = unionml_tpu_torch.Model(name="step", dataset=dataset)

        @dataset.reader
        def reader(n: int = 12) -> np.ndarray:
            return np.random.default_rng(0).integers(1, 32, size=(n, 16)).astype(np.int64)

        @model.init
        def init(hyperparameters: dict) -> TrainState:
            module = Llama(cfg, device=hyperparameters.get("device"), seed=0)
            return TrainState(module, torch.optim.SGD(module.parameters(), lr=0.1))

        step = make_train_step(causal_lm_loss)

        @model.trainer(config=TrainerConfig(epochs=1, batch_size=4, shuffle=False, log_every_steps=1, **mesh))
        def trainer(state: TrainState, batch) -> tuple:
            return step(state, batch)

        @model.evaluator(config=TrainerConfig(batch_size=5, **mesh))
        def evaluator(state: TrainState, batch) -> dict:
            return {"loss": causal_lm_loss(state.model, batch)}

        return model

    plain = app()
    _, want = plain.train(hyperparameters={"device": "cpu"}, n=12)
    meshed = app(mesh=MeshSpec(data=1), partition_rules=llama_partition_rules())
    try:
        state, got = meshed.train(hyperparameters={"device": "cpu"}, n=12)
        assert state.model.embed._mesh is not None and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert meshed.last_fit_result.history == plain.last_fit_result.history
    assert got == want
