"""The int8 weight-only matmul wrapper, its plain twin and ``quantized_matmul``.

On the CPU the port's ``int8_matmul`` takes its plain twin; it is held
against the JAX package's Pallas kernel in interpret mode
(``int8_matmul(..., interpret=True)``), within ``1e-5 * max|ref|`` in f32:
both round x to bf16, convert int8 exactly and accumulate in f32, so they
differ by summation order only. ``quantized_matmul(impl="xla")`` is held to
the JAX function's dequantize path. The hand-written kernel runs only on a
CUDA card with sm_90: its tests are marked ``cuda`` and skip elsewhere. On the
card they run without JAX installed
(``python -m pytest --noconftest -m cuda tests/test_torch_int8_matmul.py``),
so this file imports JAX only inside the CPU parity tests.
"""

import importlib

import numpy as np
import pytest
import torch

from unionml_tpu_torch.ops.quant import QuantizedKernel, QuantizedTensor, quantize_array

# the package re-exports the function under the module's name
im = importlib.import_module("unionml_tpu_torch.ops.int8_matmul")

torch.set_num_threads(2)


def _inputs(m, k, f, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, f) * rng.uniform(0.01, 2.0, size=(1, f))).astype(np.float32)
    qt = quantize_array(torch.from_numpy(w))
    return x, qt.q.numpy(), qt.scale.numpy()


def _jax_int8_matmul(x, q, scale, x_dtype, **kw):
    import jax.numpy as jnp

    from unionml_tpu.ops.int8_matmul import int8_matmul as jax_int8_matmul

    xj = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32)
    out = jax_int8_matmul(xj, jnp.asarray(q), jnp.asarray(scale), out_dtype=jnp.float32, interpret=True, **kw)
    return np.asarray(out)


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 256, 512), (5, 512, 1536), (130, 128, 256)], ids=lambda s: "x".join(map(str, s)))
def test_cpu_twin_matches_jax_interpret_kernel(shape, x_dtype):
    x, q, scale = _inputs(*shape)
    xt = torch.from_numpy(x).to(getattr(torch, x_dtype))
    before = im.int8_matmul.launches
    out = im.int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(scale), out_dtype=torch.float32)
    assert im.int8_matmul.launches == before  # CPU tensors never launch the kernel
    assert out.shape == (shape[0], shape[2]) and out.dtype == torch.float32
    ref = _jax_int8_matmul(x, q, scale, x_dtype)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_default_out_dtype_is_x_dtype():
    x, q, scale = _inputs(4, 64, 128)
    out = im.int8_matmul(torch.from_numpy(x).bfloat16(), torch.from_numpy(q), torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize(
    "shape,blocks",
    [((4, 96, 256), {}), ((4, 128, 200), {}), ((4, 256, 512), {"block_k": 96}), ((4, 256, 512), {"block_f": 384})],
    ids=["k-untileable", "f-untileable", "block_k-does-not-divide", "block_f-does-not-divide"],
)
def test_same_value_errors_as_jax(shape, blocks):
    x, q, scale = _inputs(*shape)
    with pytest.raises(ValueError) as jax_err:
        _jax_int8_matmul(x, q, scale, "float32", **blocks)
    with pytest.raises(ValueError) as port_err:
        im.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale), **blocks)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("lead", [(6,), (2, 3), (2, 1, 5)], ids=lambda s: "x".join(map(str, s)))
def test_quantized_matmul_xla_matches_jax(lead):
    import jax.numpy as jnp

    from unionml_tpu.ops.int8_matmul import quantized_matmul as jax_quantized_matmul
    from unionml_tpu.ops.quant import QuantizedTensor as JaxQuantizedTensor

    rng = np.random.RandomState(1)
    x = rng.randn(*lead, 128).astype(np.float32)
    _, q, scale = _inputs(1, 128, 256, seed=2)
    ref = np.asarray(jax_quantized_matmul(jnp.asarray(x), JaxQuantizedTensor(jnp.asarray(q), jnp.asarray(scale))))
    out = im.quantized_matmul(torch.from_numpy(x), QuantizedTensor(torch.from_numpy(q), torch.from_numpy(scale)))
    assert out.shape == lead + (256,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_quantized_matmul_pallas_routes_by_shape():
    """On CPU tensors every weight the kernel takes (K % 64, F % 16, a
    [1, F] scale; wider than the JAX tiling) goes through the kernel's twin,
    which rounds x to bf16; any other takes the dequantize path, exactly
    ``impl="xla"``, as JAX does off a TPU."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 128).astype(np.float32))
    for f, expect_twin in ((256, True), (48, True), (200, False)):
        _, q, scale = _inputs(1, 128, f, seed=4)
        qt = QuantizedTensor(torch.from_numpy(q), torch.from_numpy(scale))
        out = im.quantized_matmul(x, qt, impl="pallas")
        twin = im.int8_matmul_reference(x, qt.q, qt.scale)
        plain = im.quantized_matmul(x, qt, impl="xla")
        assert torch.equal(out, twin if expect_twin else plain)
        assert not torch.equal(twin, plain)  # the two routes do differ: bf16 x vs f32 x
    per_row = quantize_array(torch.from_numpy(rng.randn(128, 256).astype(np.float32)), channel_axis=0)  # [K, 1] scale
    assert torch.equal(im.quantized_matmul(x, per_row, impl="pallas"), im.quantized_matmul(x, per_row, impl="xla"))


@pytest.mark.parametrize("k,f,channel_axis", [(128, 200, -1), (96, 256, -1), (128, 256, 0)],
                         ids=["f-not-16", "k-not-64", "per-row-scale"])
def test_quantized_matmul_pallas_never_dequantizes_off_the_cpu(k, f, channel_axis):
    """Off the CPU the ``"pallas"`` route is the kernel or a raise: a weight
    the kernel cannot take is refused by name, before any launch (shown on
    the meta device, which needs no card)."""
    qt = quantize_array(torch.randn(k, f), channel_axis=channel_axis).to("meta")
    x = torch.empty(3, k, device="meta")
    with pytest.raises(ValueError, match="the int8 kernel takes"):
        im.quantized_matmul(x, qt, impl="pallas")
    assert im.quantized_matmul(x, qt, impl="xla").shape == (3, f)


def test_quantized_kernel_is_checked_again_after_its_buffers_change():
    """A model's int8 slot is validated at its first launch and keeps the
    verdict only while its buffers stay as checked: a move (``.to``) or a
    new ``q``/``scale`` clears it, and an unchecked slot gets every check."""
    slot = QuantizedKernel(quantize_array(torch.randn(128, 256)), impl="pallas")
    assert slot.kernel_checked is False
    for change in (lambda: slot.to("cpu"), lambda: setattr(slot, "q", slot.q.clone()),
                   lambda: setattr(slot, "scale", slot.scale.clone())):
        slot.kernel_checked = True
        change()
        assert slot.kernel_checked is False
    bad = QuantizedKernel(quantize_array(torch.randn(128, 200)), impl="pallas").to("meta")
    with pytest.raises(ValueError, match="the int8 kernel takes"):
        im.quantized_matmul(torch.empty(3, 128, device="meta"), bad, impl="pallas")


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_gradient_flows_through_the_kernel_route(x_dtype):
    """A frozen int8 base under LoRA passes dL/dx on the kernel route: the
    wrapper's backward gives the twin's own autograd gradient."""
    dtype = getattr(torch, x_dtype)
    x, q, scale = _inputs(6, 128, 256, seed=5)
    q, scale = torch.from_numpy(q), torch.from_numpy(scale)
    dy = torch.from_numpy(np.random.RandomState(6).randn(6, 256).astype(np.float32))
    x_port = torch.from_numpy(x).to(dtype).requires_grad_()
    x_twin = x_port.detach().clone().requires_grad_()
    (im.quantized_matmul(x_port, QuantizedTensor(q, scale), out_dtype=torch.float32, impl="pallas") * dy).sum().backward()
    (im.int8_matmul_reference(x_twin, q, scale, out_dtype=torch.float32) * dy).sum().backward()
    assert x_port.grad.dtype == dtype
    assert torch.equal(x_port.grad, x_twin.grad)


#: (K, F) of every Llama-3-8B matmul: q/o, k/v, wg/wi, wo, lm_head
LLAMA3_8B_WEIGHTS = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256))


def _blocks(plan, m, f):
    """The launch's grid: F tiles x N tiles x cluster ranks."""
    return -(-f // plan.f_tile) * -(-m // plan.n_tile) * plan.splits


@pytest.mark.parametrize(
    "m,n_tile",
    [(1, 8), (4, 8), (5, 8), (8, 8), (9, 16), (17, 32), (64, 64), (65, 128), (256, 256), (300, 256)],
)
def test_plan_tiles_and_splits(m, n_tile):
    n_sms = 132
    for k, f in (*LLAMA3_8B_WEIGHTS, (64, 128), (4096, 1040)):
        plan = im._plan(m, k, f, n_sms)
        # the N tile is the smallest of 8..256 that holds M (several tiles past 256)
        assert plan.n_tile == n_tile and plan.f_tile == (128 if n_tile >= 128 else 64)
        # the cluster split covers K in whole 64-row steps, every rank with at least one
        assert 1 <= plan.splits <= 16 and plan.k_per_split % 64 == 0
        assert plan.splits * plan.k_per_split >= k > (plan.splits - 1) * plan.k_per_split
        # one launch and no scratch: a plan is tiles and a split, nothing to allocate
        assert plan._fields == ("n_tile", "f_tile", "splits", "k_per_split")
        # K is split only while the grid still fits the blocks the SMs hold at once
        # (two a SM below N = 128, one at N >= 128, where a block fills the shared memory)
        assert plan.splits == 1 or _blocks(plan, m, f) <= (1 if n_tile >= 128 else 2) * n_sms
    if m <= 8:  # decode: every Llama-3-8B weight fills the card
        for k, f in LLAMA3_8B_WEIGHTS:
            assert _blocks(im._plan(m, k, f, n_sms), m, f) >= n_sms, (k, f)


@pytest.mark.parametrize("bad", ["q-int16", "scale-column", "x-noncontiguous", "x-float16", "k-not-64", "f-not-16"])
def test_kernel_inputs_are_checked(bad):
    """What the CUDA launch would refuse is refused in Python, before any
    pointer reaches the kernel (the checks are device-independent)."""
    x, q, scale = (torch.from_numpy(a) for a in _inputs(4, 64, 128))
    out_dtype = torch.float32
    if bad == "q-int16":
        q = q.to(torch.int16)
    elif bad == "scale-column":
        scale = torch.ones(64, 1)
    elif bad == "x-noncontiguous":
        x = torch.cat([x, x], dim=1)[:, ::2]
    elif bad == "k-not-64":
        x, q = x[:, :32].contiguous(), q[:32].contiguous()
    elif bad == "f-not-16":
        q, scale = q[:, :120].contiguous(), scale[:, :120].contiguous()
    else:
        x = x.half()
    with pytest.raises((TypeError, ValueError)):
        im._check(x, q, scale, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 256, 5, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_twin_on_card(dtype, m):
    _cuda_or_skip()
    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(m)
    for k, f in LLAMA3_8B_WEIGHTS:
        x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
        qt = quantize_array(torch.randn(k, f, device="cuda", generator=g) * 0.02)
        before = im.int8_matmul.launches
        out = im.int8_matmul(x, qt.q, qt.scale)
        torch.cuda.synchronize()
        assert im.int8_matmul.launches == before + 1
        ref = im.int8_matmul_reference(x, qt.q, qt.scale)
        assert out.dtype == dtype and out.shape == (m, f)
        err = (out.float() - ref.float()).abs()
        if dtype == torch.float32:  # summation order only
            assert err.max().item() <= 1e-5 * ref.abs().max().item(), (k, f, err.max().item())
        else:  # both round the f32 sum to bf16
            assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()), (k, f, err.max().item())


def _cuda_or_skip():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card with sm_90 (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("k,f", [(192, 48), (4096, 50272)], ids=["192x48", "4096x50272"])
def test_pallas_route_takes_the_kernel_beyond_the_jax_tiling_on_card(k, f):
    """Weights the JAX tiling refuses but the kernel takes (a GPT-2-sized
    head padded to 16, a narrow width) launch the kernel on the card."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(k)
    x = torch.randn(5, k, device="cuda", generator=g)
    qt = quantize_array(torch.randn(k, f, device="cuda", generator=g) * 0.02)
    before = im.int8_matmul.launches
    out = im.quantized_matmul(x, qt, impl="pallas")
    torch.cuda.synchronize()
    assert im.int8_matmul.launches == before + 1
    ref = im.int8_matmul_reference(x, qt.q, qt.scale)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
def test_pallas_route_raises_on_a_weight_the_kernel_cannot_take_on_card():
    _cuda_or_skip()
    qt = quantize_array(torch.randn(128, 200, device="cuda"))
    with pytest.raises(ValueError, match="the int8 kernel takes"):
        im.quantized_matmul(torch.randn(3, 128, device="cuda"), qt, impl="pallas")


@pytest.mark.cuda
def test_gradient_on_card_matches_cpu():
    _cuda_or_skip()
    x, q, scale = _inputs(6, 256, 512, seed=7)
    dy = np.random.RandomState(8).randn(6, 512).astype(np.float32)
    grads = []
    for device in ("cpu", "cuda"):
        xt = torch.from_numpy(x).to(device).requires_grad_()
        qt = QuantizedTensor(torch.from_numpy(q).to(device), torch.from_numpy(scale).to(device))
        (im.quantized_matmul(xt, qt, impl="pallas") * torch.from_numpy(dy).to(device)).sum().backward()
        grads.append(xt.grad.cpu())
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-2 * grads[0].abs().max().item()  # bf16-rounded dx


#: the M of the card-only checks: decode, the edges of each N tile, and ragged prefill past 256
CARD_M = (1, 7, 8, 9, 17, 64, 255, 256, 257, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,f", [(64, 128), (4096, 1040), (14336, 4096)], ids=["64x128", "4096x1040", "14336x4096"])
def test_kernel_matches_twin_at_every_tile_edge_on_card(k, f, dtype):
    """Every N tile and its ragged edges, F not a multiple of 64, and the
    longest K; f32 within 1e-5 x max|twin| (summation order only), bf16 as
    the twin rounds."""
    _cuda_or_skip()
    dtype = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(k + f)
    qt = quantize_array(torch.randn(k, f, device="cuda", generator=g) * k ** -0.5)
    for m in CARD_M:
        x = torch.randn(m, k, device="cuda", generator=g).to(dtype)
        before = im.int8_matmul.launches
        out = im.quantized_matmul(x, qt, impl="pallas")  # int8_matmul keeps the JAX tiling, which refuses F = 1040
        torch.cuda.synchronize()
        assert im.int8_matmul.launches == before + 1
        ref = im.int8_matmul_reference(x, qt.q, qt.scale)
        assert out.dtype == dtype and out.shape == (m, f)
        err = (out.float() - ref.float()).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5 * ref.abs().max().item(), (m, err.max().item())
        else:
            assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()), (m, err.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 64, 256])
def test_kernel_is_bitwise_deterministic_on_card(m):
    """The cluster ranks add their partial tiles in a fixed order: the same
    inputs give the same bits, split K included."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(m)
    for k, f in LLAMA3_8B_WEIGHTS[:4]:
        x = torch.randn(m, k, device="cuda", generator=g).bfloat16()
        qt = quantize_array(torch.randn(k, f, device="cuda", generator=g) * 0.02)
        first = im.int8_matmul(x, qt.q, qt.scale, out_dtype=torch.float32)
        second = im.int8_matmul(x, qt.q, qt.scale, out_dtype=torch.float32)
        assert torch.equal(first, second), (m, k, f, im._plan(m, k, f, torch.cuda.get_device_properties(0).multi_processor_count))


@pytest.mark.cuda
@pytest.mark.parametrize("k,f", [(64, 16), (192, 48), (128, 1040), (4096, 50272)],
                         ids=["64x16", "192x48", "128x1040", "4096x50272"])
def test_weights_of_the_earlier_kernel_still_launch_on_card(k, f):
    """The kernel's limits did not narrow: K % 64 and F % 16, any M."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(f)
    qt = quantize_array(torch.randn(k, f, device="cuda", generator=g) * 0.02)
    for m in (1, 300):
        x = torch.randn(m, k, device="cuda", generator=g)
        before = im.int8_matmul.launches
        out = im.quantized_matmul(x, qt, impl="pallas")
        torch.cuda.synchronize()
        assert im.int8_matmul.launches == before + 1
        ref = im.int8_matmul_reference(x, qt.q, qt.scale)
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
