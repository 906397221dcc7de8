"""The port's flash attention (``unionml_tpu_torch.ops.flash_attention``)
against the JAX package's, on the CPU.

On CPU tensors the port's three calls take their plain twins; the JAX side
runs its Pallas kernels in interpret mode (``_flash_forward(...,
interpret=True)`` and ``jax.grad`` through ``flash_attention(...,
interpret=True)``), as its own tests do. Inputs are f32, made with numpy from
a seed. Tolerances: 2e-5 absolute on ``out`` and ``lse``, 1e-4 on the
gradients (f32; the two sides sum over up to 256 keys and, for dk/dv, over
the query heads of a KV group in different orders). In bf16 the forward
agrees within ``BF16_FORWARD_TOL`` and the gradients within
``BF16_GRAD_TOL`` (below).

The hand-written kernels run only on a CUDA card with sm_90: those tests
are marked ``cuda`` and skip elsewhere; on the card they run without JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``),
so JAX is imported only inside the CPU parity tests.
"""

import numpy as np
import pytest
import torch

from unionml_tpu_torch.ops.attention import dot_product_attention, multihead_attention
from unionml_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_backward,
    flash_backward_dkv_reference,
    flash_backward_dq_reference,
    flash_backward_f32,
    flash_backward_reference,
    flash_forward,
    flash_forward_f32,
    flash_forward_reference,
)
from unionml_tpu_torch.ops.flash_attention import _visible

torch.set_num_threads(2)

OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4
#: (atol, rtol) of bf16 gradients against the JAX package's: each is a bf16
#: value (8 significant bits), and the two sides round at other places before
#: it (the JAX forward rounds P to bf16 before P.V, which moves out and so
#: delta; sums run in other orders), so they may be two units in the last
#: place apart: 2**-6 of the larger of the magnitude and 1
BF16_GRAD_TOL = (2.0**-6, 2.0**-6)
#: (atol, rtol) of the bf16 forward against the JAX package's: both round P to
#: bf16 before P.V and divide by the f32 row sum after it, so out differs only
#: where a last-bit difference in exp (or in a sum over keys taken in another
#: order) flips a rounding of P or of the bf16 output: within two units in the
#: last place, 2**-6 of the larger of the magnitude and 1, as BF16_GRAD_TOL
#: reasons; lse is f32 on both sides and lies far inside it
BF16_FORWARD_TOL = (2.0**-6, 2.0**-6)

#: (q_len, k_len, heads, kv_heads, causal, blocks) at B=1, D=128
CASES = {
    "causal-gqa": (256, 256, 4, 2, True, None),
    "noncausal-gqa": (256, 256, 4, 2, False, None),
    "cross-length-causal": (128, 256, 4, 2, True, None),
    "blocks-64-L192": (192, 192, 4, 2, True, (64, 64)),
}


def _inputs(q_len, k_len, heads, kv_heads, seed=0, head_dim=128):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, q_len, heads, head_dim).astype(np.float32)
    k = rng.randn(1, k_len, kv_heads, head_dim).astype(np.float32)
    v = rng.randn(1, k_len, kv_heads, head_dim).astype(np.float32)
    w = rng.randn(1, q_len, heads, head_dim).astype(np.float32)  # dLoss/dOut of loss = sum(out * w)
    return q, k, v, w


def _port_grads(q, k, v, w, **kw):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


@pytest.fixture(scope="module")
def jax_flash():
    import jax
    import jax.numpy as jnp

    from unionml_tpu.ops.flash_attention import _flash_forward, flash_attention as jax_flash_attention

    def forward(q, k, v, causal, blocks):
        out, lse = _flash_forward(*map(jnp.asarray, (q, k, v)), causal, True, blocks)
        return np.asarray(out), np.asarray(lse)

    def grads(q, k, v, w, causal, blocks):
        loss = lambda *a: (jax_flash_attention(*a, causal=causal, interpret=True, blocks=blocks) * w).sum()  # noqa: E731
        return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]

    return forward, grads


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax_interpret(jax_flash, case):
    q_len, k_len, heads, kv_heads, causal, blocks = CASES[case]
    q, k, v, _ = _inputs(q_len, k_len, heads, kv_heads)
    ref_out, ref_lse = jax_flash[0](q, k, v, causal, blocks)
    before = flash_forward.launches, flash_forward_f32.launches
    out, lse = flash_forward(*map(torch.from_numpy, (q, k, v)), causal)
    exact = flash_forward_f32(*map(torch.from_numpy, (q, k, v)), causal)
    assert (flash_forward.launches, flash_forward_f32.launches) == before  # CPU tensors never launch a kernel
    assert out.dtype == torch.float32 and lse.shape == (1, heads, q_len)
    assert torch.equal(exact[0], out) and torch.equal(exact[1], lse)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(
        flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, blocks=blocks).numpy(), ref_out,
        atol=OUT_ATOL, rtol=0,
    )


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_forward_matches_jax_interpret(jax_flash, case):
    """bf16 inputs through both packages' forwards: the port's twin rounds P
    to bf16 before P.V, as the JAX kernel does (``p.astype(v.dtype)``)."""
    import jax.numpy as jnp

    q_len, k_len, heads, kv_heads, causal, blocks = CASES[case]
    q, k, v, _ = (_bf16(a) for a in _inputs(q_len, k_len, heads, kv_heads, seed=7))
    ref_out, ref_lse = jax_flash[0](*(jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)), causal, blocks)
    out, lse = flash_forward(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32 and lse.shape == (1, heads, q_len)
    atol, rtol = BF16_FORWARD_TOL
    np.testing.assert_allclose(out.float().numpy(), ref_out.astype(np.float32), atol=atol, rtol=rtol)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=atol, rtol=rtol)


def test_forward_twin_rounds_p_to_the_operand_dtype():
    """In bf16 the forward twin multiplies V by the unnormalised P rounded to
    bf16 and divides by the f32 row sum after the product: out equals that
    computed by hand, and differs from the product of the unrounded P."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(64, 64, 2, 1, seed=8, head_dim=16))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().expand(-1, -1, 2, -1)) * 16**-0.5
    scores = scores.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True).permute(0, 2, 1, 3)
    values = v.float().expand(-1, -1, 2, -1)
    rounded = (torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), values) / l).bfloat16()
    unrounded = (torch.einsum("bhqk,bkhd->bqhd", p, values) / l).bfloat16()
    out, _ = flash_forward_reference(q, k, v, True)
    torch.testing.assert_close(out.float(), rounded.float(), atol=2**-8, rtol=2**-8)
    assert not torch.equal(rounded, unrounded)  # the rounding is visible at this size


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_grad_through_interpret(jax_flash, case):
    q_len, k_len, heads, kv_heads, causal, blocks = CASES[case]
    q, k, v, w = _inputs(q_len, k_len, heads, kv_heads, seed=1)
    ref = jax_flash[1](q, k, v, w, causal, blocks)
    _, grads = _port_grads(q, k, v, w, causal=causal, blocks=blocks)
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0, err_msg=name)


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_gradients_match_jax_grad_through_interpret(case):
    """bf16 inputs through both packages: the port's backward twins round P
    and dS to bf16 before their second products, as the JAX kernels do."""
    import jax
    import jax.numpy as jnp

    from unionml_tpu.ops.flash_attention import flash_attention as jax_flash_attention

    q_len, k_len, heads, kv_heads, causal, blocks = CASES[case]
    q, k, v, w = (_bf16(a) for a in _inputs(q_len, k_len, heads, kv_heads, seed=1))
    w_jax = jnp.asarray(w)

    def loss(*a):
        out = jax_flash_attention(*a, causal=causal, interpret=True, blocks=blocks)
        return (out.astype(jnp.float32) * w_jax).sum()

    operands = [jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v)]
    ref = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, argnums=(0, 1, 2))(*operands)]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (q, k, v))
    (flash_attention(tq, tk, tv, causal=causal, blocks=blocks).float() * torch.from_numpy(w)).sum().backward()
    atol, rtol = BF16_GRAD_TOL
    for name, t, want in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        assert t.grad.dtype == torch.bfloat16, name
        np.testing.assert_allclose(t.grad.float().numpy(), want, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_backward_twin_is_the_dq_and_dkv_twins(case, dtype):
    """``flash_backward`` and ``flash_backward_f32`` on CPU tensors are
    ``flash_backward_reference``, which equals the dq and dk/dv twins bit for
    bit; no kernel launch is counted."""
    q_len, k_len, heads, kv_heads, causal, _ = CASES[case]
    dtype = getattr(torch, dtype)
    q, k, v, w = (torch.from_numpy(a).to(dtype) for a in _inputs(q_len, k_len, heads, kv_heads, seed=4))
    out, lse = flash_forward_reference(q, k, v, causal)
    delta = torch.einsum("blhd,blhd->bhl", w.float(), out.float())
    counts = [fn.launches for fn in (flash_backward, flash_backward_f32)]
    fused = flash_backward(q, k, v, w, lse, delta, causal)
    exact = flash_backward_f32(q, k, v, w, lse, delta, causal)
    assert [fn.launches for fn in (flash_backward, flash_backward_f32)] == counts
    pair = (flash_backward_dq_reference(q, k, v, w, lse, delta, causal),
            *flash_backward_dkv_reference(q, k, v, w, lse, delta, causal))
    reference = flash_backward_reference(q, k, v, w, lse, delta, causal)
    for name, got, f32, ref, want in zip(("dq", "dk", "dv"), fused, exact, reference, pair):
        assert got.dtype == dtype and got.shape == want.shape, name
        assert torch.equal(got, want) and torch.equal(f32, want) and torch.equal(ref, want), name


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties
    away from zero), on the int32 view: the magnitude's bits plus half a unit
    of TF32's last place, the 13 bits below it cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _three_pass(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 backward kernel's products: ``a_hi b_hi + a_hi b_lo + a_lo
    b_hi`` with ``x_hi = tf32(x)`` and ``x_lo = tf32(x - x_hi)``."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(equation, a_hi, b_hi) + torch.einsum(equation, a_hi, b_lo)
            + torch.einsum(equation, a_lo, b_hi))


def _one_pass(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(equation, _tf32(a), _tf32(b))


def _emulated_backward(product, q, k, v, dout, lse, delta, causal):
    """``flash_backward_reference``'s arithmetic in f32 with its five products
    taken by ``product``: ``(dq, dk, dv)``, dk and dv summed over each KV group."""
    batch, k_len, n_kv, head_dim = k.shape
    group, scale = q.shape[2] // n_kv, head_dim**-0.5
    keys, values = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    p = torch.exp(product("bqhd,bkhd->bhqk", q, keys) * scale - lse[..., None])
    if causal:
        p = p.masked_fill(~_visible(q.shape[1], k_len, q.device), 0.0)
    ds = p * (product("bqhd,bkhd->bhqk", dout, values) - delta[..., None])
    dq = product("bhqk,bkhd->bqhd", ds, keys) * scale
    dk = (product("bhqk,bqhd->bkhd", ds, q) * scale).reshape(batch, k_len, n_kv, group, head_dim).sum(dim=3)
    dv = product("bhqk,bqhd->bkhd", p, dout).reshape(batch, k_len, n_kv, group, head_dim).sum(dim=3)
    return dq, dk, dv


#: the f32 backward's shapes on the card beside CASES: the f32 training parity's (S=256, H=32, Hkv=8, D=128)
TF32_CASES = {**CASES, "parity-S256-H32": (256, 256, 32, 8, True, None)}


@pytest.fixture(scope="module")
def emulated_backwards():
    """Per case: the twin's ``(dq, dk, dv)`` and the emulated three-pass and
    one-pass ones, computed once for the module."""
    results = {}

    def get(case):
        if case not in results:
            q_len, k_len, heads, kv_heads, causal, _ = TF32_CASES[case]
            q, k, v, w = map(torch.from_numpy, _inputs(q_len, k_len, heads, kv_heads, seed=10))
            out, lse = flash_forward_reference(q, k, v, causal)
            delta = torch.einsum("blhd,blhd->bhl", w, out)
            operands = (q, k, v, w, lse, delta, causal)
            results[case] = (flash_backward_reference(*operands), _emulated_backward(_three_pass, *operands),
                             _emulated_backward(_one_pass, *operands))
        return results[case]

    return get


def _outside_card_tolerance(got: torch.Tensor, want: torch.Tensor) -> float:
    """How far ``got`` lies past the card tests' f32 tolerance (atol 1e-4,
    rtol 1e-5) of ``want`` at its worst element: <= 0 is inside."""
    return ((got - want).abs() - (1e-4 + 1e-5 * want.abs())).max().item()


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_three_tf32_passes_stay_within_the_f32_tolerance(emulated_backwards, case):
    """The f32 backward kernel takes each product in three TF32 passes
    (3xTF32). Emulated here with ``cvt.rna``'s rounding, its dq, dk and dv
    stay within the card tests' f32 tolerance of the twin's."""
    reference, three, _ = emulated_backwards(case)
    for name, got, want in zip(("dq", "dk", "dv"), three, reference):
        assert _outside_card_tolerance(got, want) <= 0, name


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_one_tf32_pass_falls_outside_the_f32_tolerance(emulated_backwards, case):
    """The negative control: one TF32 pass a product (11 significant bits)
    puts dq, dk or dv outside that tolerance, so the test above can tell the
    two apart."""
    reference, _, one = emulated_backwards(case)
    assert max(_outside_card_tolerance(got, want) for got, want in zip(one, reference)) > 0


def _emulated_forward(product, q, k, v, causal):
    """``flash_forward_reference``'s arithmetic in f32 with its two products
    taken by ``product``: ``(out, lse)``."""
    group, scale = q.shape[2] // k.shape[2], q.shape[-1] ** -0.5
    keys, values = k.repeat_interleave(group, dim=2), v.repeat_interleave(group, dim=2)
    scores = product("bqhd,bkhd->bhqk", q, keys) * scale
    if causal:
        scores = scores.masked_fill(~_visible(q.shape[1], k.shape[1], q.device), float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = product("bhqk,bkhd->bqhd", p, values) / torch.where(l == 0, torch.ones_like(l), l).permute(0, 2, 1, 3)
    lse = torch.where(l == 0, torch.full_like(l, 1e30), m + torch.log(l))[..., 0]
    return out, lse


@pytest.fixture(scope="module")
def emulated_forwards():
    """Per case: the twin's ``(out, lse)`` and the emulated three-pass and
    one-pass ones, computed once for the module."""
    results = {}

    def get(case):
        if case not in results:
            q_len, k_len, heads, kv_heads, causal, _ = TF32_CASES[case]
            q, k, v, _ = map(torch.from_numpy, _inputs(q_len, k_len, heads, kv_heads, seed=10))
            results[case] = (flash_forward_reference(q, k, v, causal), _emulated_forward(_three_pass, q, k, v, causal),
                             _emulated_forward(_one_pass, q, k, v, causal))
        return results[case]

    return get


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_three_tf32_passes_keep_the_forward_within_the_f32_tolerance(emulated_forwards, case):
    """The f32 forward kernel takes S = Q.K^T and P.V in three TF32 passes
    each (3xTF32). Emulated here with ``cvt.rna``'s rounding, its out and lse
    stay within the card tests' f32 tolerance of the twin's."""
    reference, three, _ = emulated_forwards(case)
    for name, got, want in zip(("out", "lse"), three, reference):
        assert _outside_card_tolerance(got, want) <= 0, name


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_one_tf32_pass_puts_the_forward_outside_the_f32_tolerance(emulated_forwards, case):
    """The negative control: one TF32 pass a product puts out or lse outside
    that tolerance, so the test above can tell the two apart."""
    reference, _, one = emulated_forwards(case)
    assert max(_outside_card_tolerance(got, want) for got, want in zip(one, reference)) > 0


def test_backward_twins_round_p_and_ds_to_the_operand_dtype():
    """In bf16 the twins round P and dS to bf16 before the second products,
    as the JAX kernels do (``ds.astype(k.dtype)``, ``p.astype(do.dtype)``):
    dq equals ``scale * bf16(dS) . K`` computed by hand, and differs from the
    product of the unrounded dS."""
    q, k, v, w = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(64, 64, 2, 1, seed=5, head_dim=16))
    out, lse = flash_forward_reference(q, k, v, True)
    delta = torch.einsum("blhd,blhd->bhl", w.float(), out.float())
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().expand(-1, -1, 2, -1)) * 16**-0.5
    scores = scores.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), float("-inf"))
    p = torch.exp(scores - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", w.float(), v.float().expand(-1, -1, 2, -1)) - delta[..., None])
    keys = k.float().expand(-1, -1, 2, -1)
    rounded = (torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(), keys) * 16**-0.5).bfloat16()
    unrounded = (torch.einsum("bhqk,bkhd->bqhd", ds, keys) * 16**-0.5).bfloat16()
    dq = flash_backward_dq_reference(q, k, v, w, lse, delta, True)
    torch.testing.assert_close(dq.float(), rounded.float(), atol=2**-8, rtol=2**-8)
    assert not torch.equal(rounded, unrounded)  # the rounding is visible at this size


def test_misaligned_fully_masked_rows_follow_the_contract_not_the_pallas_kernel():
    """``Lq=256, Lk=192, blocks=(128, 64)``: the causal offset ``Lk - Lq =
    -64`` is not a multiple of ``block_q``, so query rows 0-63 see no key.
    The contract (``dot_product_attention``, both packages) gives those rows
    0 and the backward lse ``1e30``. The JAX Pallas forward does not: its
    masked scores are ``finfo.min``, not ``-inf``, so ``exp(m - m) = 1`` and
    such a row, sharing a computed 128-row tile with rows that see keys,
    returns the mean of V and lse ``finfo.min + log(block_k)``. The port
    holds to the contract."""
    from unionml_tpu.ops.attention import dot_product_attention as jax_attention

    q, k, v, w = _inputs(256, 192, 4, 2, seed=2)
    ref = np.asarray(jax_attention(q, k, v, causal=True))
    out, grads = _port_grads(q, k, v, w, causal=True, blocks=(128, 64))
    np.testing.assert_allclose(out, ref, atol=OUT_ATOL, rtol=0)
    assert not out[:, :64].any()
    _, lse = flash_forward(*map(torch.from_numpy, (q, k, v)), True)
    assert (lse[:, :, :64] == 1e30).all() and (lse[:, :, 64:] < 1e3).all()
    dense = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (dot_product_attention(*dense, causal=True) * torch.from_numpy(w)).sum().backward()
    for name, got, t in zip(("dq", "dk", "dv"), grads, dense):
        np.testing.assert_allclose(got, t.grad.numpy(), atol=GRAD_ATOL, rtol=0, err_msg=name)
    assert not grads[0][:, :64].any()  # a row that sees nothing has no query gradient


@pytest.mark.parametrize(
    "shapes,blocks,match",
    [
        (((1, 64, 3, 16), (1, 64, 2, 16)), None, "must be a multiple of KV heads"),
        (((1, 192, 2, 16), (1, 192, 1, 16)), None, r"blocks \(128, 128\) do not tile lengths \(192, 192\)"),
        (((1, 64, 2, 16), (1, 96, 1, 16)), (64, 64), r"blocks \(64, 64\) do not tile lengths \(64, 96\)"),
    ],
    ids=["kv-heads", "default-blocks", "custom-blocks"],
)
def test_shape_errors_match_jax_messages(shapes, blocks, match):
    q, k = torch.zeros(shapes[0]), torch.zeros(shapes[1])
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, k, causal=True, blocks=blocks)


def test_masked_and_auto_calls_stay_on_the_plain_path(monkeypatch):
    """Only an unmasked ``impl="flash"`` call reaches ``flash_attention``
    (``test_torch_layers.py`` checks that one); a masked call takes the
    plain path as in the JAX package, whose kernels take no mask."""
    from unionml_tpu_torch.ops import attention as attention_module

    monkeypatch.setattr(attention_module, "flash_attention", lambda *a, **kw: pytest.fail("reached flash"))
    q = torch.randn(1, 4, 2, 16)
    mask = torch.ones(1, 1, 4, 4, dtype=torch.bool)
    out = multihead_attention(q, q, q, mask=mask, impl="flash")
    torch.testing.assert_close(out, dot_product_attention(q, q, q, mask=mask))
    multihead_attention(q, q, q, causal=True, impl="auto")


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA card with sm_90 (the kernels have no CPU mode)")


#: card-only cases beside CASES: (q_len, k_len, heads, kv_heads, causal, blocks) and the head dim. The f32
#: forward takes 128-row blocks where their grid fills the card (wide-L1000-D100), else 64-row blocks
CARD_CASES = {
    "ragged-L40-D64": ((40, 40, 4, 1, True, None), 64),
    "wide-L1000-D100": ((1000, 1000, 32, 8, True, None), 100),
}


def _card_inputs(case: str, dtype: torch.dtype, seed: int = 3):
    (q_len, k_len, heads, kv_heads, causal, _), head_dim = CARD_CASES.get(case, (CASES.get(case), 128))
    arrays = _inputs(q_len, k_len, heads, kv_heads, seed, head_dim)
    q, k, v, w = (torch.from_numpy(a).cuda().to(dtype) for a in arrays)
    return q, k, v, w, causal


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["cross-length-causal", "blocks-64-L192", "ragged-L40-D64"])
def test_kernels_match_twins_on_card(card, dtype, case):
    """The forward and the backward against their twins: float32 through the
    f32 forward and the fused f32 backward (3xTF32), bfloat16 through the
    tensor-core forward and the fused bf16 backward."""
    dtype = getattr(torch, dtype)
    q, k, v, w, causal = _card_inputs(case, dtype)
    counted = (flash_forward, flash_forward_f32, flash_backward, flash_backward_f32)
    counts = [fn.launches for fn in counted]
    out, lse = flash_forward(q, k, v, causal)
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal)
    delta = torch.einsum("blhd,blhd->bhl", w.float(), ref_out.float())
    dq, dk, dv = flash_backward(q, k, v, w, ref_lse, delta, causal)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert [fn.launches - c for fn, c in zip(counted, counts)] == [bf16, not bf16, bf16, not bf16]
    ref_dq, ref_dk, ref_dv = flash_backward_reference(q, k, v, w, ref_lse, delta, causal)
    # f32: f32 sums in other orders (3xTF32 products: about 2**-22 of each); bf16: outputs round to 8 bits
    atol, rtol = (1e-4, 1e-5) if dtype == torch.float32 else (2e-2, 2e-2)
    for got, want in ((out, ref_out), (lse, ref_lse), (dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, "ragged-L40-D64"])
def test_fused_backward_matches_twin_and_is_deterministic_on_card(card, case):
    """The fused bf16 kernel against ``flash_backward_reference`` (the twin's
    lse and delta), and two calls bitwise equal (dq's adds are ordered)."""
    q, k, v, w, causal = _card_inputs(case, torch.bfloat16, seed=6)
    out, lse = flash_forward_reference(q, k, v, causal)
    delta = torch.einsum("blhd,blhd->bhl", w.float(), out.float())
    got = flash_backward(q, k, v, w, lse, delta, causal)
    again = flash_backward(q, k, v, w, lse, delta, causal)
    torch.cuda.synchronize()
    reference = flash_backward_reference(q, k, v, w, lse, delta, causal)
    for name, a, b, want in zip(("dq", "dk", "dv"), got, again, reference):
        assert a.dtype == torch.bfloat16 and a.shape == want.shape, name
        torch.testing.assert_close(a.float(), want.float(), atol=2e-2, rtol=2e-2, msg=name)
        assert torch.equal(a, b), name


def _one_call(fn, *args):
    """``fn(*args)`` once more under the profiler and the sync debugger: its
    result and the names of the device kernels the call ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host synchronisation in the call would raise
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = fn(*args)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    names = [e.name for e in prof.events() if str(e.device_type).endswith("CUDA") and e.device_time > 0]
    return got, names


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, "ragged-L40-D64"])
def test_f32_backward_matches_twin_and_is_deterministic_on_card(card, case):
    """The fused f32 kernel against ``flash_backward_reference`` at the f32
    tolerance; a second call gives the same bits (dq's adds are ordered),
    runs exactly one launch of the kernel (beside the allocations' fills and
    the group sums) and never synchronises the host."""
    q, k, v, w, causal = _card_inputs(case, torch.float32, seed=6)
    out, lse = flash_forward_reference(q, k, v, causal)
    delta = torch.einsum("blhd,blhd->bhl", w, out)
    counts = flash_backward.launches, flash_backward_f32.launches
    got = flash_backward(q, k, v, w, lse, delta, causal)
    again, names = _one_call(flash_backward, q, k, v, w, lse, delta, causal)
    assert (flash_backward.launches - counts[0], flash_backward_f32.launches - counts[1]) == (0, 2)
    assert sum("flash_backward_f32_kernel" in name for name in names) == 1, names
    reference = flash_backward_reference(q, k, v, w, lse, delta, causal)
    for name, a, b, want in zip(("dq", "dk", "dv"), got, again, reference):
        assert a.dtype == torch.float32 and a.shape == want.shape, name
        torch.testing.assert_close(a, want, atol=1e-4, rtol=1e-5, msg=name)
        assert torch.equal(a, b), name


def _misaligned_on_card(a: np.ndarray) -> torch.Tensor:
    """``a`` on the card, starting 4 bytes past a 16-byte boundary."""
    flat = torch.empty(a.size + 1, device="cuda")[1:]
    return flat.copy_(torch.from_numpy(a).cuda().flatten()).view(a.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,misaligned", [(7, False), (36, False), (100, False), (128, True), (20, True)])
def test_f32_backward_takes_any_head_dim_and_alignment_on_card(card, head_dim, misaligned):
    """Head dims that are not multiples of 8 (or of 4: plain loads in place of
    the 16-byte copies), tensors that start off a 16-byte boundary, and
    ``Lq=256, Lk=192`` causal, where query rows 0-63 see no key (their dq is
    0): all at the twin's f32 tolerance."""
    arrays = _inputs(256, 192, 4, 2, seed=12, head_dim=head_dim)
    q, k, v, w = (_misaligned_on_card(a) if misaligned else torch.from_numpy(a).cuda() for a in arrays)
    assert not misaligned or q.data_ptr() % 16
    out, lse = flash_forward_reference(q, k, v, True)
    delta = torch.einsum("blhd,blhd->bhl", w, out)
    before = flash_backward_f32.launches
    got = flash_backward(q, k, v, w, lse, delta, True)
    torch.cuda.synchronize()
    assert flash_backward_f32.launches == before + 1
    for name, a, want in zip(("dq", "dk", "dv"), got, flash_backward_reference(q, k, v, w, lse, delta, True)):
        torch.testing.assert_close(a, want, atol=1e-4, rtol=1e-5, msg=name)
    assert not got[0][:, :64].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, *CARD_CASES])
def test_f32_forward_matches_twin_and_is_deterministic_on_card(card, case):
    """The f32 forward (3xTF32 tensor-core products) against
    ``flash_forward_reference`` at the f32 tolerance; a second call gives the
    same bits, runs exactly one launch of the kernel and never synchronises
    the host; only ``flash_forward_f32`` counts the launches."""
    q, k, v, _, causal = _card_inputs(case, torch.float32, seed=13)
    counts = flash_forward.launches, flash_forward_f32.launches
    out, lse = flash_forward(q, k, v, causal)
    (again, again_lse), names = _one_call(flash_forward_f32, q, k, v, causal)
    assert (flash_forward.launches - counts[0], flash_forward_f32.launches - counts[1]) == (0, 2)
    assert sum("flash_forward_f32_kernel" in name for name in names) == 1, names
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("head_dim", [7, 20, 36, 64, 100, 128])
def test_f32_forward_takes_any_head_dim_and_alignment_on_card(card, head_dim, misaligned):
    """Head dims that are not multiples of 16 (or of 4: 4-byte copies in
    place of the 16-byte ones), tensors that start off a 16-byte boundary,
    and ``Lq=256, Lk=192`` causal, where query rows 0-63 see no key (they
    give 0 and lse ``1e30``): all at the twin's f32 tolerance."""
    arrays = _inputs(256, 192, 4, 2, seed=14, head_dim=head_dim)[:3]
    q, k, v = (_misaligned_on_card(a) if misaligned else torch.from_numpy(a).cuda() for a in arrays)
    assert not misaligned or q.data_ptr() % 16
    before = flash_forward_f32.launches
    out, lse = flash_forward(q, k, v, True)
    torch.cuda.synchronize()
    assert flash_forward_f32.launches == before + 1
    ref_out, ref_lse = flash_forward_reference(q, k, v, True)
    torch.testing.assert_close(out, ref_out, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    assert not out[:, :64].any() and (lse[:, :, :64] == 1e30).all()


@pytest.mark.cuda
def test_fused_backward_raises_on_head_dims_it_cannot_take(card):
    """bf16 with ``D % 16 != 0`` (or ``D > 128``) raises before any launch;
    it never falls back to a twin or to the f32 kernel."""
    before = [fn.launches for fn in (flash_backward, flash_backward_f32)]
    for head_dim in (40, 136):
        q = torch.randn(1, 64, 2, head_dim, device="cuda").bfloat16()
        lse = torch.zeros(1, 2, 64, device="cuda")
        with pytest.raises(ValueError, match="head_dim"):
            flash_backward(q, q, q, q, lse, lse, True)
    assert [fn.launches for fn in (flash_backward, flash_backward_f32)] == before


@pytest.mark.cuda
def test_f32_kernels_refuse_bf16_on_card(card):
    """The f32 forward and the fused f32 backward take float32 only (bf16 is
    the bf16 kernels'): bf16 raises ``TypeError`` before any launch, as does a
    head dim past 128 ``ValueError``."""
    counted = (flash_forward, flash_forward_f32, flash_backward, flash_backward_f32)
    before = [fn.launches for fn in counted]
    q = torch.randn(1, 64, 2, 64, device="cuda").bfloat16()
    lse = torch.zeros(1, 2, 64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        flash_forward_f32(q, q, q, True)
    with pytest.raises(TypeError, match="float32"):
        flash_backward_f32(q, q, q, q, lse, lse, True)
    q = torch.randn(1, 64, 2, 136, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_forward_f32(q, q, q, True)
    with pytest.raises(ValueError, match="head_dim"):
        flash_backward_f32(q, q, q, q, lse, lse, True)
    assert [fn.launches for fn in counted] == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, "ragged-L40-D64"])
def test_bf16_forward_matches_twin_and_is_deterministic_on_card(card, case):
    """The tensor-core bf16 forward against ``flash_forward_reference``, and
    two calls bitwise equal; the f32 forward is not launched."""
    q, k, v, _, causal = _card_inputs(case, torch.bfloat16, seed=9)
    counts = flash_forward.launches, flash_forward_f32.launches
    out, lse = flash_forward(q, k, v, causal)
    again = flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert (flash_forward.launches - counts[0], flash_forward_f32.launches - counts[1]) == (2, 0)
    ref_out, ref_lse = flash_forward_reference(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32 and lse.shape == ref_lse.shape
    # both round P to bf16 (a last-bit difference in exp can flip one rounding) and the output to 8 bits
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
def test_bf16_forward_rows_that_see_no_key_on_card(card):
    """``Lq=256, Lk=192``, causal: query rows 0-63 see no key and give 0 and
    lse ``1e30``; the rest match the twin."""
    q, k, v, _ = (torch.from_numpy(a).cuda().bfloat16() for a in _inputs(256, 192, 4, 2, seed=2))
    out, lse = flash_forward(q, k, v, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_forward_reference(q, k, v, True)
    assert not out[:, :64].any() and (lse[:, :, :64] == 1e30).all()
    torch.testing.assert_close(out.float(), ref_out.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_bf16_forward_raises_on_inputs_it_cannot_take(card):
    """bf16 with ``D % 16 != 0`` or ``D > 128``, and float32 sent to the bf16
    entry, raise before any launch; nothing falls back to a twin."""
    from unionml_tpu_torch.ops.flash_attention import _forward_bf16

    before = flash_forward.launches, flash_forward_f32.launches
    for head_dim in (40, 136):
        q = torch.randn(1, 64, 2, head_dim, device="cuda").bfloat16()
        with pytest.raises(ValueError, match="head_dim"):
            flash_forward(q, q, q, True)
    q = torch.randn(1, 64, 2, 64, device="cuda")
    with pytest.raises(TypeError, match="bfloat16"):
        _forward_bf16(q, q, q, True)
    assert (flash_forward.launches, flash_forward_f32.launches) == before
