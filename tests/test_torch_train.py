"""The port's training path (``unionml_tpu_torch.train``, the LoRA helpers and
chunked loss of ``models/llama.py``) against the JAX package's, on the CPU.

A tiny f32 LoRA Llama takes the same weights (through the weight bridge)
and the same numpy token windows on both sides. The port trains with
``attention_impl="flash"``, whose CPU tensors take the kernels' plain twins;
the JAX side uses ``attention_impl="auto"`` on its emulated 8-device mesh
(a batch of 8 divides it). Tolerances are stated where they are used.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from unionml_tpu import TrainerConfig as JaxTrainerConfig, make_train_step as jax_make_train_step
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models.llama import (
    chunked_causal_lm_loss as jax_chunked_loss,
    lora_optimizer as jax_lora_optimizer,
    lora_param_labels as jax_lora_param_labels,
)
from unionml_tpu.train import fit as jax_fit
from unionml_tpu_torch import Llama, LlamaConfig, TrainerConfig, TrainState, evaluate, fit, make_train_step
from unionml_tpu_torch.models import (
    causal_lm_loss,
    chunked_causal_lm_loss,
    llama_params_from_jax,
    llama_params_to_numpy,
    lora_optimizer,
    lora_param_labels,
)

torch.set_num_threads(2)

LR, SEQ, BATCH, EPOCHS, N_WINDOWS = 1e-2, 17, 8, 2, 32
STEPS = EPOCHS * N_WINDOWS // BATCH


def _jax_tree(cfg, seed=0):
    """Flax params with nonzero ``lora_b`` (at zero, step one leaves every
    ``lora_a`` gradient at zero and half the adapter math untested)."""
    params = JaxLlama(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, SEQ), jnp.int32))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape) * 0.05).astype(np.float32)
        if "lora_b" in jax.tree_util.keystr(path) else np.asarray(a),
        params,
    )


def _port_model(tree, **overrides):
    cfg = LlamaConfig.tiny(lora_rank=4, dtype=torch.float32, param_dtype=torch.float32, **overrides)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(tree, cfg))
    return model


def _windows(vocab, n=N_WINDOWS, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, size=(n, SEQ)).astype(np.int32)


def _leaves(tree, keyword):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in flat if keyword in jax.tree_util.keystr(p)}


@pytest.fixture(scope="module")
def jax_run():
    """JAX ``fit`` of a tiny LoRA Llama: (initial tree, FitResult)."""
    cfg = JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32, param_dtype=jnp.float32)
    tree = _jax_tree(cfg)
    module = JaxLlama(cfg)
    state = train_state.TrainState.create(
        apply_fn=module.apply, params=jax.tree_util.tree_map(jnp.asarray, tree), tx=jax_lora_optimizer(LR)
    )
    step = jax_make_train_step(lambda p, b: jax_chunked_loss(module, p, b, chunk_size=8))
    result = jax_fit(state, step, _windows(cfg.vocab_size),
                     JaxTrainerConfig(epochs=EPOCHS, batch_size=BATCH, seed=3, log_every_steps=1))
    return tree, result


def _port_fit(tree, config, **overrides):
    model = _port_model(tree, attention_impl="flash", **overrides)
    state = TrainState(model, lora_optimizer(model, LR))
    step = make_train_step(lambda m, b: chunked_causal_lm_loss(m, b, chunk_size=8))
    return fit(state, step, _windows(model.config.vocab_size), config, device="cpu")


def test_fit_matches_jax_fit_step_for_step(jax_run):
    """Loss history: 1e-5 relative (f32; the two sides sum in different
    orders). Trained adapters after 8 AdamW steps at lr 1e-2: 1e-5 absolute
    for any entry and 1e-6 on the mean (measured 1.6e-6 and 2.3e-7; Adam
    divides each gradient by its own root mean square, so a gradient near
    zero carries the f32 rounding of both sides into a whole step)."""
    tree, ref = jax_run
    result = _port_fit(tree, TrainerConfig(epochs=EPOCHS, batch_size=BATCH, seed=3, log_every_steps=1))
    assert result.steps == ref.steps == STEPS
    assert [h["step"] for h in result.history] == [h["step"] for h in ref.history]
    np.testing.assert_allclose([h["loss"] for h in result.history], [h["loss"] for h in ref.history], rtol=1e-5)
    trained, want = _leaves(llama_params_to_numpy(result.state.model), "lora"), _leaves(ref.state.params, "lora")
    assert trained.keys() == want.keys()
    diffs = np.concatenate([np.abs(trained[k] - want[k]).ravel() for k in want])
    assert diffs.max() <= 1e-5 and diffs.mean() <= 1e-6
    frozen = _leaves(llama_params_to_numpy(result.state.model), "kernel")
    for key, value in _leaves(tree, "kernel").items():
        np.testing.assert_array_equal(frozen[key], value)


def test_checkpoint_resume_reproduces_the_schedule(tmp_path, jax_run):
    """Resume from a checkpoint at step 4 skips the 4 consumed batches and
    ends where an uninterrupted run ends (bit-equal on the CPU)."""
    tree, _ = jax_run
    full = _port_fit(tree, TrainerConfig(epochs=EPOCHS, batch_size=BATCH, seed=3, log_every_steps=1))
    ckpt = dict(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every_steps=2, max_checkpoints_to_keep=2)
    first = _port_fit(tree, TrainerConfig(epochs=1, batch_size=BATCH, seed=3, log_every_steps=1, **ckpt))
    assert first.steps == 4
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["step_2.pt", "step_4.pt"]
    resumed = _port_fit(tree, TrainerConfig(epochs=EPOCHS, batch_size=BATCH, seed=3, log_every_steps=1,
                                            resume=True, **ckpt))
    assert resumed.steps == STEPS - 4 and resumed.state.step == STEPS
    assert [h["step"] for h in resumed.history] == [5, 6, 7, 8]
    assert resumed.history == full.history[4:]
    for (name, a), b in zip(resumed.state.model.named_parameters(), full.state.model.parameters()):
        assert torch.equal(a, b), name


def test_device_data_and_host_batching_take_the_same_steps(jax_run):
    """``device_data`` (one permute per epoch, contiguous slices, 3 steps per
    payload) sees the host path's batches in the host path's order."""
    tree, _ = jax_run
    host = _port_fit(tree, TrainerConfig(epochs=EPOCHS, batch_size=BATCH, seed=3, log_every_steps=1))
    dev = _port_fit(tree, TrainerConfig(epochs=EPOCHS, batch_size=BATCH, seed=3, log_every_steps=1,
                                        device_data=True, steps_per_call=3))
    # payloads of 3, 1 (epoch end), 3, 1: history logs each payload's last step
    assert [h["step"] for h in dev.history] == [3, 4, 7, 8]
    by_step = {h["step"]: h["loss"] for h in host.history}
    assert all(h["loss"] == pytest.approx(by_step[h["step"]], rel=1e-6) for h in dev.history)


def test_grad_accumulation_averages_microbatch_gradients():
    """Two microbatches of 4 give the gradient of the batch of 8 (the mean
    loss over equal-size halves), so one step moves the adapters alike
    (f32, 1e-6 absolute)."""
    tree = _jax_tree(JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32, param_dtype=jnp.float32))
    batch = torch.from_numpy(_windows(512, n=8))
    results = []
    for accum in (1, 2):
        model = _port_model(tree)
        state = TrainState(model, torch.optim.SGD([p for n, p in model.named_parameters() if "lora" in n], lr=1.0))
        state, metrics = make_train_step(causal_lm_loss, grad_accum_steps=accum)(state, batch)
        results.append((metrics["loss"].item(), llama_params_to_numpy(model)))
    assert results[0][0] == pytest.approx(results[1][0], rel=1e-6)
    for key, value in _leaves(results[0][1], "lora").items():
        np.testing.assert_allclose(_leaves(results[1][1], "lora")[key], value, atol=1e-6)


def test_chunked_loss_equals_plain_loss_and_gradients():
    """As the JAX package's own test, with and without a mask: 32 targets in
    chunks of 13 (the third padded); loss 1e-5 relative and gradients 1e-5
    absolute against the plain loss, and the value equals JAX's chunked loss
    (1e-5 relative)."""
    cfg = JaxLlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128, vocab_size=97,
                              dtype=jnp.float32, param_dtype=jnp.float32)
    module = JaxLlama(cfg)
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 33), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    port_cfg = LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128, vocab_size=97,
                                dtype=torch.float32, param_dtype=torch.float32)
    model = Llama(port_cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(tree, port_cfg))
    tokens = np.random.RandomState(0).randint(0, 97, size=(3, 33)).astype(np.int32)
    mask = (tokens > 10).astype(np.int32)
    for batch in (torch.from_numpy(tokens), (torch.from_numpy(tokens), torch.from_numpy(mask))):
        losses, grads = [], []
        for loss_fn in (causal_lm_loss, lambda m, b: chunked_causal_lm_loss(m, b, chunk_size=13)):
            model.zero_grad()
            loss = loss_fn(model, batch)
            loss.backward()
            losses.append(loss.item())
            grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        assert losses[1] == pytest.approx(losses[0], rel=1e-5)
        for name, g in grads[0].items():
            torch.testing.assert_close(grads[1][name], g, atol=1e-5, rtol=0)
        jax_batch = jnp.asarray(tokens) if isinstance(batch, torch.Tensor) else (jnp.asarray(tokens), jnp.asarray(mask))
        assert losses[1] == pytest.approx(float(jax_chunked_loss(module, params, jax_batch, chunk_size=13)), rel=1e-5)


def test_lora_labels_and_optimizer_freeze_the_base_and_step_like_optax():
    """Labels match flax's leaf for leaf; ``lora_optimizer`` freezes every
    base weight, and one AdamW step on given gradients equals
    ``optax.adamw`` with the JAX package's defaults (1e-6 absolute, f32)."""
    cfg = JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32, param_dtype=jnp.float32)
    tree = _jax_tree(cfg)
    model = _port_model(tree)
    labels = lora_param_labels(model)
    want = {k.replace("']['", ".").strip("[']"): v for k, v in _leaves(jax_lora_param_labels(tree), "").items()}
    assert labels == {k: str(v) for k, v in want.items()}
    assert labels["layer_0.attn.q_proj.lora_a"] == "lora" and labels["layer_0.attn.q_proj.kernel"] == "frozen"

    optimizer = lora_optimizer(model, LR)
    assert optimizer.defaults["weight_decay"] == 1e-4 and optimizer.defaults["betas"] == (0.9, 0.999)
    assert all(p.requires_grad == (labels[n] == "lora") for n, p in model.named_parameters())
    rng = np.random.RandomState(5)
    grads = [{n: rng.randn(*p.shape).astype(np.float32) for n, p in model.named_parameters()} for _ in range(2)]
    tx = jax_lora_optimizer(LR)
    flat = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    nested = lambda d: {"tree": d}  # noqa: E731  (a pytree whose paths carry the "lora" names)
    opt_state = tx.init(nested(flat))
    for g in grads:
        updates, opt_state = tx.update(nested({n: jnp.asarray(a) for n, a in g.items()}), opt_state, nested(flat))
        flat = optax.apply_updates(nested(flat), updates)["tree"]
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n]) if p.requires_grad else None
        optimizer.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(flat[n]), atol=1e-6, rtol=0, err_msg=n)


def test_remat_recomputes_blocks_with_equal_gradients():
    cfg_tree = _jax_tree(JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32, param_dtype=jnp.float32))
    tokens = torch.from_numpy(_windows(512, n=2))
    grads = []
    for remat in (False, True):
        model = _port_model(cfg_tree, remat=remat, attention_impl="flash")
        causal_lm_loss(model, tokens).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_evaluate_weights_partial_batches():
    tree = _jax_tree(JaxLlamaConfig.tiny(lora_rank=4, dtype=jnp.float32, param_dtype=jnp.float32))
    model = _port_model(tree)
    state = TrainState(model, lora_optimizer(model))
    windows = _windows(512, n=10)
    metrics = evaluate(state, lambda s, b: {"loss": causal_lm_loss(s.model, b)}, windows, batch_size=4, device="cpu")
    with torch.no_grad():
        whole = causal_lm_loss(model, torch.from_numpy(windows)).item()
    assert metrics["loss"] == pytest.approx(whole, rel=1e-5)  # 4 + 4 + 2 rows, weighted by rows


@pytest.mark.parametrize(
    "option", [dict(mesh=object()), dict(partition_rules=[]), dict(logical_axis_rules=[]),
               dict(shard_batch_by_process=True)],
    ids=["mesh", "partition_rules", "logical_axis_rules", "shard_batch_by_process"],
)
def test_multi_device_options_raise_pointing_at_the_roadmap(option):
    model = Llama(dataclasses.replace(LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32)),
                  device="cpu", seed=0)
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue A: parallelism and the replica layer"):
        fit(state, make_train_step(causal_lm_loss), _windows(512, n=8), TrainerConfig(batch_size=4, **option),
            device="cpu")
