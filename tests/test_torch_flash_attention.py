"""The port's fp32-inside attention (vit2spn_tpu_torch/ops/flash_attention.py)
against the JAX package's `mha_pallas`, whose Pallas kernels run in interpret
mode on the CPU as tests/test_attention.py runs them.

On the CPU the wrappers run the kernels' plain twins; the CUDA kernels
(csrc/flash_attention.cu) are held against the twins on the card by
chip_smoke.py. Inputs come from numpy with a seed and go to both sides."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit2spn_tpu.ops.flash_attention import mha_pallas as jax_mha_pallas
from vit2spn_tpu_torch.ops import flash_attention as fa
from vit2spn_tpu_torch.ops import fused_block as fb
from vit2spn_tpu_torch.ops.attention import mha_plain, multi_head_attention

torch.set_num_threads(1)

SHAPES = [(2, 197, 3, 64), (1, 5, 1, 64)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    cot = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, cot


def _jax(q, k, v, cot, jdt):
    """Output and (dq, dk, dv) of the JAX mha_pallas in interpret mode, for
    the loss sum(out * cot)."""
    args = tuple(jnp.asarray(t, jdt) for t in (q, k, v))

    def loss(*a):
        out = jax_mha_pallas(*a, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(*args)
    return out, grads


def _port(q, k, v, cot, tdt):
    args = [torch.from_numpy(t).to(tdt).requires_grad_(True) for t in (q, k, v)]
    out = fa.mha_pallas(*args)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, [t.grad for t in args]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=["vit_tiny", "short"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_pallas_matches_jax(shape, dtype):
    """Forward and the three gradients. fp32: tests/test_attention.py's
    tolerances (2e-5 forward, 5e-5 gradients): both sides compute in fp32
    and differ by reassociation only. bf16: both compute in fp32 and round
    only the outputs, so a value near a rounding boundary lands one bf16 step
    (2**-8 relative) away: the largest difference within 1% of the output's
    largest magnitude, the mean within 0.1%."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, cot = _inputs(shape, 0)
    ref, ref_g = _jax(q, k, v, cot, jdt)
    got, got_g = _port(q, k, v, cot, tdt)
    assert got.dtype == tdt and all(g.dtype == tdt for g in got_g)
    for name, a, b, tol in [("out", got, ref, 2e-5)] + [
            (f"d{n}", a, b, 5e-5) for n, a, b in zip("qkv", got_g, ref_g)]:
        a, b = _f32(a), _f32(b)
        assert a.shape == b.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=name)
        else:
            scale = float(np.abs(b).max())
            err = np.abs(a - b)
            assert err.max() <= 1e-2 * scale, (name, float(err.max()), scale)
            assert err.mean() <= 1e-3 * scale, (name, float(err.mean()), scale)


def test_softmax_rows_sum_to_one_under_padding():
    """No probability mass reaches the pad keys: with v == ones every output
    row is 1 (tests/test_attention.py's check, on the port)."""
    q, k, _, _ = _inputs((1, 5, 1, 64), 1)
    ones = torch.ones((1, 5, 1, 64))
    out = fa.mha_pallas(torch.from_numpy(q), torch.from_numpy(k), ones)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)
    ref = jax_mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.ones((1, 5, 1, 64)),
                         interpret=True)
    np.testing.assert_allclose(np.asarray(ref), 1.0, atol=1e-5)


def test_function_matches_autograd_of_the_plain_twin():
    """fp32: the Function's explicit backward (`flash_attention_bwd_plain`)
    against torch autograd through `flash_attention_plain`: the same
    function, summed in other orders (1e-5 on gradients of order 1)."""
    q, k, v, cot = _inputs((2, 9, 2, 64), 2)
    got, got_g = _port(q, k, v, cot, torch.float32)
    args = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_plain(*args)
    (out * torch.from_numpy(cot)).sum().backward()
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    for a, t in zip(got_g, args):
        torch.testing.assert_close(a, t.grad, rtol=1e-5, atol=1e-5)


def test_fp32_probabilities_set_it_apart_from_mha_plain():
    """In bf16 the two attention forms differ where mha_plain rounds P to
    bf16 before P.V; in fp32 they agree."""
    q, k, v, _ = _inputs((1, 33, 2, 64), 3)
    t32 = [torch.from_numpy(a) for a in (q, k, v)]
    torch.testing.assert_close(fa.mha_pallas(*t32), mha_plain(*t32), rtol=0, atol=2e-6)
    tb = [a.to(torch.bfloat16) for a in t32]
    ref = fa.flash_attention_plain(*[a.double() for a in tb])
    err_flash = (fa.mha_pallas(*tb).double() - ref).abs().mean()
    err_plain = (mha_plain(*tb).double() - ref).abs().mean()
    assert err_flash < err_plain


def test_multi_head_attention_dispatch():
    q, k, v, _ = _inputs((1, 7, 2, 64), 4)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    torch.testing.assert_close(multi_head_attention(*t, "xla"), mha_plain(*t))
    torch.testing.assert_close(multi_head_attention(*t, "pallas"), fa.mha_pallas(*t))
    with pytest.raises(ValueError, match="unknown attention impl"):
        multi_head_attention(*t, "pallas_interpret")


def test_cpu_calls_count_no_launches():
    q, k, v, cot = _inputs((1, 5, 1, 64), 5)
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    _port(q, k, v, cot, torch.float32)
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == before


def test_kernel_input_checks():
    """What the CUDA kernels do not take is refused before any launch (plain
    Python checks, so they run here); views of a split qkv are taken as
    they lie."""
    qkv = torch.zeros((2, 9, 3 * 128), dtype=torch.bfloat16)
    q, k, v = (t.reshape(2, 9, 2, 64) for t in qkv.split(128, dim=-1))
    fa._check_flash_inputs(q, k, v)
    fa._check_flash_inputs(*(t.float().contiguous() for t in (q, k, v)))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fa._check_flash_inputs(*(t.half() for t in (q, k, v)))
    x = torch.zeros((2, 9, 4, 32), dtype=torch.bfloat16)  # head_dim 32
    fa._check_flash_inputs(x, x, x)
    # head_dim 32 above 256 tokens: the general route's multi-pass kernels
    x = torch.zeros((1, fb.KERNEL_MAX_SEQ + 1, 4, 32), dtype=torch.bfloat16)
    fa._check_flash_inputs(x, x, x)
    fa._check_flash_inputs(x.float(), x.float(), x.float())
    # head_dim 80 (ViT-Huge/14) takes the streamed kernels at every S; 96 is refused
    x = torch.zeros((2, 9, 2, 80), dtype=torch.bfloat16)
    fa._check_flash_inputs(x, x, x)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((2, 9, 2, 96), dtype=torch.bfloat16)
        fa._check_flash_inputs(x, x, x)
    # above 256 tokens bf16 and fp32 take the long-sequence routes
    x = torch.zeros((1, fb.KERNEL_MAX_SEQ + 1, 1, 64), dtype=torch.bfloat16)
    fa._check_flash_inputs(x, x, x)
    fa._check_flash_inputs(x.float(), x.float(), x.float())
    with pytest.raises(ValueError, match="k must match"):
        fa._check_flash_inputs(q, k.float(), v)
    with pytest.raises(ValueError, match="strides"):
        fa._check_flash_inputs(q, k.contiguous(), v)
    with pytest.raises(ValueError, match="side by side"):
        x = torch.zeros((2, 2, 9, 64), dtype=torch.bfloat16).transpose(1, 2)
        fa._check_flash_inputs(x, x, x)
    # token rows 68 elements apart: 8-byte aligned, enough for fp32 only
    x = torch.zeros((2, 9, 1, 68))[..., :64]
    fa._check_flash_inputs(x, x, x)
    with pytest.raises(ValueError, match="rows 16-byte aligned"):
        x = torch.zeros((2, 9, 1, 68), dtype=torch.bfloat16)[..., :64]
        fa._check_flash_inputs(x, x, x)
    m = torch.zeros((1, 5, 1, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_fwd(m, m, m)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_bwd(m, m, m, m)


def _terms(x, mode):
    """x as the bf16 kernels feed an fp32 operand to the tensor cores: two
    bf16 terms hi = bf16(x), lo = bf16(x - hi) ("split"), or one ("bf16")."""
    hi = x.to(torch.bfloat16).float()
    return [hi, (x - hi).to(torch.bfloat16).float()] if mode == "split" else [hi]


def _emulate(q, k, v, do, mode):
    """`flash_attention_plain` and `flash_attention_bwd_plain` with P and dS
    entering P v, P^T dO, dS k and dS^T q as `_terms(., mode)`, each term's
    product summed in fp32. Returns (o, dq, dk, dv) in bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = fa._probs(q, k)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))

    def prod(eq, x, y):
        return sum(torch.einsum(eq, t, y) for t in _terms(x, mode))

    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    out = (prod("bhqk,bkhd->bqhd", p, vf), prod("bhqk,bkhd->bqhd", ds, kf) * scale,
           prod("bhqk,bqhd->bkhd", ds, qf) * scale, prod("bhqk,bqhd->bkhd", p, dof))
    return tuple(t.to(torch.bfloat16) for t in out)


def _attention_f64(q, k, v, do):
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    return (torch.einsum("bhqk,bkhd->bqhd", p, v), torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale, torch.einsum("bhqk,bqhd->bkhd", p, do))


def _mean_errors(got, ref):
    """Mean |got - ref| over the largest |ref|, per output."""
    return [float((a.double() - r).abs().mean() / r.abs().max()) for a, r in zip(got, ref)]


def test_two_term_split_of_p_and_ds_keeps_the_fp32_function():
    """The premise of the bf16 CUDA kernels (csrc/flash_attention.cu): P and
    dS fed to the tensor cores as two bf16 terms leave o, dq, dk, dv as close
    to float64 as the fp32 twins (mean error within 1.05x theirs, the ratio
    chip_smoke.py holds the kernels to), while one bf16 term of each, the
    fused block's attention, lands further away than that ratio allows."""
    rng = np.random.default_rng(6)
    shape = (2, 197, 3, 64)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    do = torch.from_numpy(0.1 * rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    ref = _attention_f64(q, k, v, do)
    twin = _mean_errors((fa.flash_attention_plain(q, k, v),
                         *fa.flash_attention_bwd_plain(q, k, v, do)), ref)
    split = _mean_errors(_emulate(q, k, v, do, "split"), ref)
    one = _mean_errors(_emulate(q, k, v, do, "bf16"), ref)
    for name, e_t, e_s, e_1 in zip(("o", "dq", "dk", "dv"), twin, split, one):
        assert e_s <= 1.05 * e_t, (name, e_s, e_t)
        assert e_1 > 1.05 * e_t, (name, e_1, e_t)
