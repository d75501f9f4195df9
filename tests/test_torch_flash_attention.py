"""The port's flash attention (tpu_bootstrap_torch/workload/flash_attention.py)
held to the JAX reference on the CPU: (out, lse) and the gradients of a
weighted sum of out plus lse, on MHA and GQA (group 2 and 4), causal and
not, at unaligned lengths; the reference's argument errors; and the flash
prefill of decode.py. On the CPU the port runs the kernels' plain versions
(dense masked f32 attention and its hand-written backward); the reference's
Pallas kernels run in interpret mode.

Tolerances: f32 on both sides, so the two differ only in the order of f32
sums (the reference folds 16-row tiles online, the plain version sums
whole rows): gradients to 5e-5, as the reference's own flash-vs-dense
tests; out and lse against a float64 evaluation (see the forward test).

The bf16 kernels round P and dS to bf16 before their second products; a
test-local emulation of that arithmetic is held to the reference in bf16
under the limits ``chip_smoke.py`` holds the card to, and controls (a KV
tile skipped, delta' dropped, the lse cotangent ignored) must land outside
them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpu_bootstrap.workload import decode as jdecode
from tpu_bootstrap.workload import flash_attention as jfa
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import flash_attention as tfa
from tpu_bootstrap_torch.workload import model as tmodel

torch.set_num_threads(2)

HEADS, HEAD_DIM, BLOCK = 4, 16, 16


def _inputs(seed, b, s, hk):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, HEADS, HEAD_DIM)).astype(np.float32)
    k = rng.standard_normal((b, s, hk, HEAD_DIM)).astype(np.float32)
    v = rng.standard_normal((b, s, hk, HEAD_DIM)).astype(np.float32)
    w = rng.standard_normal((b, s, HEADS, HEAD_DIM)).astype(np.float32)
    wl = rng.standard_normal((b, s, HEADS)).astype(np.float32)
    return q, k, v, w, wl


def _attention_f64(q, k, v, causal):
    """(out, lse) of the same masked softmax in float64 numpy."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    g = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[1]
        s = np.where(np.tril(np.ones((n, n), bool)), s, -1e30)
    m = s.max(-1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(-1, keepdims=True))
    out = np.einsum("bhqk,bkhd->bqhd", np.exp(s - lse), v)
    return out, lse[..., 0].transpose(0, 2, 1)


@pytest.mark.parametrize("hk,causal,s", [(4, True, 40), (4, False, 13),
                                         (2, True, 13), (2, False, 40),
                                         (1, True, 40), (1, False, 13)])
def test_forward_matches_reference(hk, causal, s):
    """Both against a float64 evaluation of the same formula. The port is
    held to 2e-5: f32 rounding over at most 40 terms stays under that. The
    reference's interpret-mode kernel is held to 1e-4: one parallel run of
    the suite saw the two packages 7.6e-5 apart (4.8e-5 relative) on 7 of
    5120 elements, which no later run repeated, so the port is compared
    with the truth both approximate rather than with the reference alone."""
    q, k, v, _, _ = _inputs(0, 2, s, hk)
    # The port runs first, on copies, and the reference is waited for, so
    # neither side can read the inputs while the other computes.
    to, tl = tfa.flash_attention_with_lse(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        block_size=BLOCK)
    jo, jl = jax.block_until_ready(jfa.flash_attention_with_lse(
        jnp.array(q), jnp.array(k), jnp.array(v), causal=causal,
        block_size=BLOCK))
    assert to.shape == q.shape and tl.shape == (2, s, HEADS)
    assert tl.dtype == torch.float32
    want, want_lse = _attention_f64(q, k, v, causal)
    for name, out, lse, tol in (
            ("port", to.numpy(), tl.numpy(), 2e-5),
            ("reference", np.asarray(jo), np.asarray(jl), 1e-4)):
        np.testing.assert_allclose(out, want, atol=tol, rtol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(lse, want_lse, atol=tol, rtol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("hk,causal,s", [(4, True, 40), (2, False, 13),
                                         (1, True, 13)])
def test_grads_of_out_and_lse_match_reference(hk, causal, s):
    """The scalar is sum(out * w) + sum(lse * wl): the lse cotangent is
    nonzero, so a backward that dropped it would fail here."""
    q, k, v, w, wl = _inputs(1, 2, s, hk)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                              block_size=BLOCK)
        return jnp.sum(o * w) + jnp.sum(lse * wl)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=causal,
                                          block_size=BLOCK)
    loss = (o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(wl)).sum()
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for g, x, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=5e-5,
                                   rtol=5e-5, err_msg=name)


def test_lse_cotangent_changes_the_gradients_as_autograd_says():
    """The hand-written backward (delta' = rowsum(dO * O) - dlse) against
    torch autograd through the plain forward, with and without an lse
    cotangent; the two cotangents must give different gradients."""
    q, k, v, w, wl = _inputs(2, 2, 21, 2)
    results = {}
    for name, weight in (("with", wl), ("without", np.zeros_like(wl))):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        o, lse = tfa.flash_attention_with_lse(tq, tk, tv, causal=True)
        o2, lse2 = tfa.attention_plain(tq, tk, tv, HEAD_DIM ** -0.5, True)
        wt, wlt = torch.from_numpy(w), torch.from_numpy(weight)
        got = torch.autograd.grad((o * wt).sum() + (lse * wlt).sum(),
                                  (tq, tk, tv))
        want = torch.autograd.grad((o2 * wt).sum() + (lse2 * wlt).sum(),
                                   (tq, tk, tv))
        for g, x in zip(got, want):
            torch.testing.assert_close(g, x, atol=5e-5, rtol=5e-5)
        results[name] = got
    # lse depends on q and k only: dq and dk move with its cotangent, dv
    # does not.
    dq, dk, dv = (a - b for a, b in zip(results["with"], results["without"]))
    assert dq.abs().max() > 1e-3 and dk.abs().max() > 1e-3
    assert dv.abs().max() < 1e-6


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _kernel_rounding(q, k, v, w, wl, causal, skip=None, delta_term=True,
                     dlse_term=True):
    """The bf16 kernels' arithmetic in whole-matrix form (a model of
    csrc/flash_attention_sm90.cu, not a path of the package): bf16
    operands, f32 scores scaled after the product, P (unnormalised, against
    the row max) and dS rounded to bf16 before P V, P^T dO, dS^T Q and
    dS K, every sum in f32, outputs rounded to bf16. Controls: ``skip``
    masks the KV columns [skip, skip + 16) as a kernel that skipped a tile
    would; ``delta_term`` False drops delta', ``dlse_term`` False ignores
    the lse cotangent. Returns (out, lse, dq, dk, dv)."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = d ** -0.5
    kr, vr = (torch.repeat_interleave(t, g, dim=2) for t in (k, v))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale
    keep = torch.ones(s, s, dtype=torch.bool)
    if causal:
        keep = keep.tril()
    if skip is not None:
        keep[:, skip:skip + 16] = False
    sc = sc.masked_fill(~keep, -1e30)
    m = sc.max(-1, keepdim=True).values
    pt = torch.exp(sc - m)
    l = pt.sum(-1, keepdim=True)
    out = (torch.einsum("bhqk,bkhd->bhqd", _bf16(pt), vr) / l).transpose(1, 2)
    lse = (m + torch.log(l))[..., 0].transpose(1, 2)
    out = _bf16(out)
    delta = (w * out).sum(-1) * delta_term - wl * (delta_term and dlse_term)
    p = torch.exp(sc - lse.transpose(1, 2)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", w, vr)
    ds = _bf16(p * (dp - delta.transpose(1, 2)[..., None]))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), w)
    dk, dv = (t.reshape(b, s, -1, g, d).sum(3) for t in (dk, dv))
    return out, lse, _bf16(dq), _bf16(dk), _bf16(dv)


def _tol_ratio(got, want, tol) -> float:
    rtol, atol = tol
    return float(np.max(np.abs(got - want) / (rtol * np.abs(want) + atol)))


def _rel_err(got, want) -> float:
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("hk,causal", [(4, True), (4, False), (2, True),
                                       (2, False)])
def test_bf16_rounding_scheme_within_the_card_limits(hk, causal):
    """The bf16 kernels' rounding (emulated) against the reference's Pallas
    kernels (interpret mode) on the same bf16 inputs, at an unaligned
    length and a head dim whose scale is not a power of two: out, lse and
    the gradients of sum(out * w) + sum(lse * wl) stay within half of
    chip_smoke's bf16 limits, and each control lands above them."""
    s, d = 77, 32
    rng = np.random.default_rng(9)
    # bf16-representable inputs, the same on both sides.
    q, k, v, w = (_bf16(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32))).numpy() for shape in ((2, s, HEADS, d), (2, s, hk, d),
                                            (2, s, hk, d), (2, s, HEADS, d)))
    wl = rng.standard_normal((2, s, HEADS)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                              block_size=BLOCK)
        return jnp.sum(o.astype(jnp.float32) * w) + jnp.sum(lse * wl)

    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jo, jl = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal,
                                          block_size=BLOCK)
    grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    ref = [np.asarray(x.astype(jnp.float32)) for x in (jo, jl, *grads)]
    args = [torch.from_numpy(a) for a in (q, k, v, w, wl)]
    out_tol = chip_smoke.K3_OUT_TOL["bfloat16"]
    lse_tol = chip_smoke.K3_LSE_TOL
    grad_tol = chip_smoke.FLASH_TOL["bfloat16"]

    def errors(got):
        got = [t.numpy() for t in got]
        return (_tol_ratio(got[0], ref[0], out_tol),
                _tol_ratio(got[1], ref[1], lse_tol),
                [_rel_err(g, x) for g, x in zip(got[2:], ref[2:])])

    out_r, lse_r, grad_e = errors(_kernel_rounding(*args, causal))
    assert out_r <= 0.5 and lse_r <= 0.5, (out_r, lse_r)
    assert max(grad_e) <= grad_tol / 2, grad_e
    # A skipped KV tile moves out, lse and every gradient past its limit.
    out_r, lse_r, grad_e = errors(_kernel_rounding(*args, causal, skip=32))
    assert out_r > 1 and lse_r > 1 and min(grad_e) > grad_tol, (
        out_r, lse_r, grad_e)
    # Without delta', or without the lse cotangent, dq and dk leave theirs.
    for control in ({"delta_term": False}, {"dlse_term": False}):
        _, _, grad_e = errors(_kernel_rounding(*args, causal, **control))
        assert min(grad_e[:2]) > grad_tol, (control, grad_e)


def test_tiling_arguments_do_not_change_the_result():
    q, k, v, _, _ = _inputs(3, 1, 30, 2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    base = tfa.flash_attention(tq, tk, tv)
    for kw in ({"block_size": 8}, {"block_size": 32, "block_k": 8},
               {"block_size": 16, "block_k": 16}):
        assert torch.equal(tfa.flash_attention(tq, tk, tv, **kw), base)
    fn = tfa.make_flash_attn_fn(block_size=16)
    assert torch.equal(fn(tq, tk, tv), base)


@pytest.mark.parametrize("shapes,kw,match", [
    ((64, 4, 50, 4), {}, "incompatible"),
    ((64, 3, 64, 3), {}, "must divide"),
    ((64, 4, 64, 4), {"block_size": 60}, "multiple of 8"),
    ((64, 4, 64, 4), {"block_k": 0}, "positive multiple of 8"),
    ((64, 4, 64, 4), {"block_size": 64, "block_k": 48}, "must divide"),
    ((64, 4, 64, 4), {"block_size": 64, "block_k": 128}, "must not exceed"),
    ((20, 4, 20, 4), {"block_size": 64, "block_k": 16}, "effective q block"),
])
def test_argument_errors_match_reference(shapes, kw, match):
    sq, hq, skv, hkv = shapes
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, sq, hq, HEAD_DIM)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, HEAD_DIM)).astype(np.float32)
    if hq == 3:  # 3 kv heads against 4 q heads
        q = rng.standard_normal((2, sq, 4, HEAD_DIM)).astype(np.float32)
    with pytest.raises(ValueError, match=match) as want:
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                            **kw)
    with pytest.raises(ValueError, match=match) as got:
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(k), **kw)
    assert str(got.value) == str(want.value)


CFG = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
           embed_dim=32, mlp_dim=48, max_seq_len=64, num_kv_heads=2)


def _models(seed=5):
    jcfg, tcfg = jmodel.ModelConfig(**CFG), tmodel.ModelConfig(**CFG)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_flash_prefill_matches_reference_and_einsum_prefill():
    jcfg, tcfg, jparams, tparams = _models()
    tokens = np.random.default_rng(6).integers(0, 64, (2, 19))
    jcache = jdecode.init_cache(jcfg, 2, 24)
    want, _ = jdecode.prefill(jparams, jnp.asarray(tokens), jcache, jcfg,
                              kv_kernel=False, flash=True, all_logits=True)
    got = {}
    for flash in (True, False):
        caches = tdecode.init_cache(tcfg, 2, 24, device="cpu")
        got[flash], _ = tdecode.prefill(tparams, torch.from_numpy(tokens),
                                        caches, tcfg, all_logits=True,
                                        flash=flash)
    np.testing.assert_allclose(got[True].numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got[True], got[False], atol=1e-4, rtol=1e-4)


def test_generate_with_flash_prefill_matches_reference():
    jcfg, tcfg, jparams, tparams = _models(seed=7)
    prompt = np.random.default_rng(8).integers(0, 64, (2, 11))
    want = np.asarray(jdecode.generate(jparams, jnp.asarray(prompt), jcfg, 5,
                                       kv_kernel=False, prefill_flash=True))
    got = tdecode.generate(tparams, prompt, tcfg, 5, prefill_flash=True,
                           device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_flash_prefill_refuses_ragged_prompts():
    _, tcfg, _, tparams = _models()
    with pytest.raises(ValueError, match="prompt_lengths"):
        tdecode.generate(tparams, [[1, 2, 3]], tcfg, 2, prefill_flash=True,
                         prompt_lengths=[2], device="cpu")
    caches = tdecode.init_cache(tcfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        tdecode.prefill(tparams, torch.tensor([[1, 2, 3]]), caches, tcfg,
                        lengths=torch.tensor([2]), flash=True)
