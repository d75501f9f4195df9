"""The port's decode paths (tpu_bootstrap_torch/workload/decode.py and
speculative._verify_chunk) held to the JAX reference on the CPU, on the
same bridged int8 params: one paged decode step (logits and the pools it
writes), the vector-position prefill chunk, greedy generation with an
int8 KV cache on the einsum path (``kv_kernel=False``, the solo oracle the
serving engines are held to), and the same generation on the kernel path
(K5's plain version here), routed as the reference routes it; sampled
generation (test_decode.py:69-110) on the reference's keys, with the
split chain and with row keys, eagerly and through the captured step."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import decode as jdecode
from tpu_bootstrap.workload import decode_attention as jda
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import speculative as jspec
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import decode_attention as tda
from tpu_bootstrap_torch.workload import graphs
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import prng
from tpu_bootstrap_torch.workload import speculative as tspec

torch.set_num_threads(2)

BASE = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
            embed_dim=32, mlp_dim=64, max_seq_len=64)


def _setup(seed=0, **kw):
    jcfg = jmodel.ModelConfig(**{**BASE, **kw})
    tcfg = tmodel.ModelConfig(**{**BASE, **kw})
    jparams = jquant.quantize_params(
        jmodel.init_params(jcfg, jax.random.PRNGKey(seed)))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    return jcfg, tcfg, jparams, tparams


def _random_kv(rng, shape, layers):
    """Equal int8 KV content for both packages, quantized by the
    reference (the quantizers are bit-equal, tests/test_torch_decode_
    attention.py)."""
    out = []
    for _ in range(layers):
        layer = {}
        for name in ("k", "v"):
            q, s = jdecode._quantize_kv(jnp.asarray(
                rng.standard_normal(shape).astype(np.float32)))
            layer[name], layer[name + "_scale"] = np.asarray(q), np.asarray(s)
        out.append(layer)
    return out


def _to_jax(pools):
    return [{n: jnp.asarray(a) for n, a in layer.items()} for layer in pools]


def _to_torch(pools):
    return [{n: torch.from_numpy(a.copy()) for n, a in layer.items()}
            for layer in pools]


# Logits of the int8 path agree to this: the int8 matmul rounds its
# activations to bf16 (the reference kernel's own cast), and where the
# two frameworks' f32 transcendentals (tanh gelu, exp) differ in the last
# ulp, one activation element may round to the neighbouring bf16 value.
LOGIT_ATOL = 5e-3
# A greedy step whose top-2 logit margin is below the logit tolerance may
# fairly pick either token: a divergence there is a near-tie, reported
# and not failed.
NEAR_TIE = LOGIT_ATOL


def assert_greedy_equal(got: dict, want: dict, prompts: dict, tparams,
                        tcfg, kv_quant: bool = True) -> list:
    """Token streams {key: tokens} equal, except where the first divergent
    step is a near-tie by the port's own solo logits on the int8 KV cache
    (``kv_quant``) or the float one (warned, returned)."""
    near = []
    for key, w in want.items():
        g = list(got[key])
        w = list(w)
        if g == w:
            continue
        assert len(g) == len(w), (key, g, w)
        j = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        margin = tdecode.greedy_margins(tparams, prompts[key], w[:j + 1],
                                        tcfg, kv_quant=kv_quant,
                                        device="cpu")[j]
        assert margin < NEAR_TIE, (
            f"{key}: streams diverge at step {j} with top-2 margin "
            f"{margin:.3g} >= {NEAR_TIE}: {g} != {w}")
        near.append((key, j, margin))
    if near:
        warnings.warn(f"near-ties (key, step, margin): {near}")
    return near


def _assert_pools_close(got, want):
    """Written KV equal up to what the logit tolerance allows upstream: a
    dequantized value within one quantization step plus LOGIT_ATOL, and
    at most 2% of the int8 values different."""
    for gl, wl in zip(got, want):
        for name in ("k", "v"):
            gq, wq = gl[name].numpy(), np.asarray(wl[name])
            gs = gl[name + "_scale"].numpy()[..., None]
            ws = np.asarray(wl[name + "_scale"])[..., None]
            assert (np.abs(gq * gs - wq * ws) <= ws + LOGIT_ATOL).all(), name
            assert (gq != wq).mean() < 2e-2, name


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_paged_decode_step_matches_reference(kv_heads):
    jcfg, tcfg, jparams, tparams = _setup(num_kv_heads=kv_heads)
    rng = np.random.default_rng(1)
    bs, nblk = 8, 10
    pools = _random_kv(rng, (nblk, bs, tcfg.kv_heads, BASE["head_dim"]),
                       BASE["num_layers"])
    # Row 0 decodes inside its second block, row 1 at a block's first
    # slot, row 2 is a dummy on the null block, row 3 overshoots its
    # table (the logical block clamps to the last column).
    bt = np.asarray([[4, 2, 0], [7, 0, 0], [0, 0, 0], [5, 6, 9]], np.int32)
    pos = np.asarray([11, 0, 0, 30], np.int32)
    token = np.asarray([5, 9, 0, 17], np.int32)
    jlogits, jpools = jdecode.paged_decode_step(
        jparams, jnp.asarray(token), jnp.asarray(pos), _to_jax(pools),
        jnp.asarray(bt), jcfg)
    tpools = _to_torch(pools)
    tlogits, out_pools = tdecode.paged_decode_step(
        tparams, torch.from_numpy(token).long(), torch.from_numpy(pos),
        tpools, torch.from_numpy(bt), tcfg)
    assert out_pools is tpools  # updated in place
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_pools_close(tpools, jpools)


# The int4 and MoE weight formats: (model config, reference quantizer).
FORMATS = {
    "dense_int4": ({}, lambda p: jquant.quantize_params4(p, group=16)),
    "moe_int8": ({"num_experts": 4}, jquant.quantize_params),
    "moe_int4": ({"num_experts": 4},
                 lambda p: jquant.quantize_params4(p, group=16, head="int4")),
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_int4_and_moe_decode_match_reference(fmt):
    """prefill on an int8 cache and one paged decode step on a dense int4
    model (K6 projections, int8 head), a MoE int8 model (K1 projections,
    K1e experts) and a MoE int4 model (K6, K6e, int4 head), on bridged
    reference weights: logits to LOGIT_ATOL, KV as in the int8 test."""
    kw, quantize = FORMATS[fmt]
    jcfg = jmodel.ModelConfig(**{**BASE, **kw})
    tcfg = tmodel.ModelConfig(**{**BASE, **kw})
    # The reference jitted (both packages read the same bridged bytes, so
    # XLA's rewrites of the quantizer do not matter here).
    jparams = jax.jit(lambda key: quantize(jmodel.init_params(jcfg, key)))(
        jax.random.PRNGKey(8))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, BASE["vocab_size"], (2, 7)).astype(np.int32)
    jlogits, jcaches = jax.jit(jdecode.prefill,
                               static_argnames=("cfg", "kv_kernel"))(
        jparams, jnp.asarray(tokens), jdecode.init_cache(jcfg, 2, 12, True),
        cfg=jcfg, kv_kernel=False)
    tcaches = tdecode.init_cache(tcfg, 2, 12, quantized=True, device="cpu")
    tlogits, _ = tdecode.prefill(tparams, torch.from_numpy(tokens).long(),
                                 tcaches, tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_pools_close(tcaches, jcaches)
    bs = 8
    pools = _random_kv(rng, (6, bs, tcfg.kv_heads, BASE["head_dim"]),
                       BASE["num_layers"])
    bt = np.asarray([[4, 2], [1, 0], [0, 0]], np.int32)
    pos = np.asarray([11, 3, 0], np.int32)
    token = np.asarray([5, 9, 0], np.int32)
    jlogits, jpools = jax.jit(jdecode.paged_decode_step,
                              static_argnames=("cfg",))(
        jparams, jnp.asarray(token), jnp.asarray(pos), _to_jax(pools),
        jnp.asarray(bt), cfg=jcfg)
    tpools = _to_torch(pools)
    tlogits, _ = tdecode.paged_decode_step(
        tparams, torch.from_numpy(token).long(), torch.from_numpy(pos),
        tpools, torch.from_numpy(bt), tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_pools_close(tpools, jpools)


def test_verify_chunk_vector_pos_matches_reference():
    jcfg, tcfg, jparams, tparams = _setup(seed=2, num_kv_heads=2)
    rng = np.random.default_rng(3)
    b, c, length = 3, 5, 24
    caches = _random_kv(rng, (b, length, 2, BASE["head_dim"]),
                        BASE["num_layers"])
    tokens = rng.integers(0, BASE["vocab_size"], (b, c)).astype(np.int32)
    pos = np.asarray([0, 7, 19], np.int32)  # row 2 ends at the last slot
    jlogits, jcaches = jspec._verify_chunk(
        jparams, jnp.asarray(tokens), jnp.asarray(pos), _to_jax(caches),
        jcfg, kv_kernel=False)
    tcaches = _to_torch(caches)
    tlogits, _ = tspec._verify_chunk(
        tparams, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
        tcaches, tcfg)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)
    _assert_pools_close(tcaches, jcaches)
    # The serving prefill chunk skips the head and writes the same KV.
    again = _to_torch(caches)
    none, _ = tspec._verify_chunk(
        tparams, torch.from_numpy(tokens).long(), torch.from_numpy(pos),
        again, tcfg, logits=False)
    assert none is None
    for g, w in zip(again, tcaches):
        for n in g:
            assert torch.equal(g[n], w[n])


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_int8_kv_matches_reference(ragged):
    jcfg, tcfg, jparams, tparams = _setup(seed=4)
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, BASE["vocab_size"], (3, 9)).astype(np.int32)
    lengths = np.asarray([9, 4, 1], np.int32) if ragged else None
    steps = 12
    want = np.asarray(jdecode.generate(
        jparams, jnp.asarray(prompt), jcfg, steps, kv_quant=True,
        kv_kernel=False,
        prompt_lengths=None if lengths is None else jnp.asarray(lengths)))
    got = tdecode.generate(tparams, prompt, tcfg, steps, kv_quant=True,
                           kv_kernel=False, prompt_lengths=lengths,
                           device="cpu")
    assert got.shape == (3, steps)
    prompts = {row: prompt[row, 9 - (9 if lengths is None else lengths[row]):]
               .tolist() for row in range(3)}
    # Seed 4 has no divergent row; a near-tie would be reported.
    assert_greedy_equal(dict(enumerate(got.tolist())),
                        dict(enumerate(want.tolist())), prompts, tparams,
                        tcfg)


def test_greedy_margins_replay_generate():
    _, tcfg, _, tparams = _setup(seed=6)
    prompt = [3, 14, 15, 9, 2]
    toks = tdecode.generate(tparams, [prompt], tcfg, 6, kv_quant=True,
                            kv_kernel=False, device="cpu")[0].tolist()
    margins = tdecode.greedy_margins(tparams, prompt, toks, tcfg,
                                     kv_quant=True, device="cpu")
    assert len(margins) == 6 and min(margins) >= 0.0


def test_generate_options_not_ported_raise():
    """Sampling is ported (tests/test_torch_sampled_serving.py): what is
    left here are the reference's refusals of its arguments, the same
    ValueError in both packages."""
    jcfg, tcfg, jparams, tparams = _setup()
    key = jax.random.PRNGKey(0)
    rows = jnp.stack([key, key])
    for kw, match in (
            ({"temperature": 0.7, "top_p": 0.0}, "top_p must be in"),
            ({"temperature": 0.7, "top_p": 1.5}, "top_p must be in"),
            ({"temperature": 0.7, "row_key_offsets": [0, 1]},
             "row_key_offsets requires row_keys"),
            ({"row_keys": rows}, "temperature is 0")):
        jkw = {k: (jnp.asarray(v, jnp.int32) if k == "row_key_offsets"
                   else v) for k, v in kw.items()}
        with pytest.raises(ValueError, match=match):
            jdecode.generate(jparams, jnp.asarray([[1, 2], [3, 4]]), jcfg, 2,
                             **jkw)
        tkw = {k: (np.asarray(v) if k == "row_keys" else v)
               for k, v in kw.items()}
        with pytest.raises(ValueError, match=match):
            tdecode.generate(tparams, [[1, 2], [3, 4]], tcfg, 2,
                             device="cpu", **tkw)


def _counting(monkeypatch):
    """Count the calls to decode_attention_int8 (the K5 wrapper) that the
    decode paths make."""
    calls = {"n": 0}
    real = tda.decode_attention_int8

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tda, "decode_attention_int8", counting)
    return calls


def test_generate_int8kv_routes_through_kernel(monkeypatch):
    """generate(kv_quant=True) takes the kernel on every decode step of
    every layer (AUTO is on) and kv_kernel=False never does; ragged
    prompts (per-row masks) and a float cache never do either."""
    _, tcfg, _, tparams = _setup(seed=10)
    prompt = np.random.default_rng(11).integers(1, 64, (2, 5))
    steps = 9
    calls = _counting(monkeypatch)
    with_kernel = tdecode.generate(tparams, prompt, tcfg, steps,
                                   kv_quant=True, device="cpu")
    assert calls["n"] == (steps - 1) * BASE["num_layers"]
    for kw in ({"kv_kernel": False}, {"prompt_lengths": [5, 3]},
               {"kv_quant": False}):
        calls["n"] = 0
        tdecode.generate(tparams, prompt, tcfg, steps,
                         **{"kv_quant": True, **kw}, device="cpu")
        assert calls["n"] == 0, kw
    # The kernel's online softmax and the einsum's softmax round alike
    # here: greedy tokens equal.
    without = tdecode.generate(tparams, prompt, tcfg, steps, kv_quant=True,
                               kv_kernel=False, device="cpu")
    assert torch.equal(with_kernel, without)


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_generate_int8kv_kernel_matches_reference(monkeypatch, kv_heads):
    """The kernel path on both sides: the cache (9 + 15 = 24 slots) is a
    multiple of 8, so the reference's generate takes its Pallas kernel
    (interpret mode) on every decode step as the port takes K5's plain
    version. Greedy streams through assert_greedy_equal; one decode step's
    logits over the same caches to LOGIT_ATOL."""
    jcfg, tcfg, jparams, tparams = _setup(seed=12, num_kv_heads=kv_heads)
    rng = np.random.default_rng(13)
    prompt = rng.integers(1, BASE["vocab_size"], (3, 9)).astype(np.int32)
    steps = 15
    assert jda.supports(9 + steps, tcfg.kv_heads, BASE["head_dim"])
    want = np.asarray(jdecode.generate(jparams, jnp.asarray(prompt), jcfg,
                                       steps, kv_quant=True))
    calls = _counting(monkeypatch)
    got = tdecode.generate(tparams, prompt, tcfg, steps, kv_quant=True,
                           device="cpu")
    assert calls["n"] == (steps - 1) * BASE["num_layers"]
    assert_greedy_equal(dict(enumerate(got.tolist())),
                        dict(enumerate(want.tolist())),
                        {row: prompt[row].tolist() for row in range(3)},
                        tparams, tcfg)
    # One kernel step on both sides over the same prefilled caches.
    length = 24
    jcaches = jdecode.init_cache(jcfg, 3, length, True)
    _, jcaches = jdecode.prefill(jparams, jnp.asarray(prompt), jcaches, jcfg)
    token = np.array(want[:, 0])
    jlogits, _ = jdecode.decode_step(jparams, jnp.asarray(token),
                                     jnp.asarray(9), jcaches, jcfg)
    tcaches = tdecode.init_cache(tcfg, 3, length, quantized=True,
                                 device="cpu")
    tdecode.prefill(tparams, torch.from_numpy(prompt).long(), tcaches, tcfg)
    calls["n"] = 0
    tlogits, _ = tdecode.decode_step(tparams, torch.from_numpy(token).long(),
                                     9, tcaches, tcfg)
    assert calls["n"] == BASE["num_layers"]
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOGIT_ATOL)


def test_bf16_stored_weights_match_reference():
    """Weights stored in bf16 (bench.py's bf16 baseline and speculative
    target): the f32 head promotes the bf16 embedding as the reference
    does. Prefill logits over the same bf16 values to 1e-4 (f32 compute,
    sums in other orders)."""
    jcfg = jmodel.ModelConfig(**BASE)
    tcfg = tmodel.ModelConfig(**BASE)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(14))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    tparams = {"embed": tparams["embed"].bfloat16(),
               "final_norm": tparams["final_norm"].bfloat16(),
               "blocks": [{n: w.bfloat16() for n, w in b.items()}
                          for b in tparams["blocks"]]}
    tokens = np.random.default_rng(15).integers(1, 64, (2, 6)).astype(np.int32)
    jlogits, _ = jdecode.prefill(jparams, jnp.asarray(tokens),
                                 jdecode.init_cache(jcfg, 2, 8), jcfg)
    tlogits, _ = tdecode.prefill(tparams, torch.from_numpy(tokens).long(),
                                 tdecode.init_cache(tcfg, 2, 8, device="cpu"),
                                 tcfg)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("head_dim", [64, 48])
def test_attend_scale_is_the_reference_f32_scale(head_dim):
    """The einsum path's score scale is a host float, computed once: the
    scores equal, bit for bit, those of the expression it replaced (an f32
    tensor scalar copied to the device every layer), and the scale equals
    the reference's jnp.asarray(head_dim, f32) ** -0.5 bit for bit."""
    rng = np.random.default_rng(head_dim)
    q = torch.from_numpy(rng.standard_normal((2, 3, 4, 2, head_dim))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 7, 4, head_dim))
                         .astype(np.float32))
    raw = torch.einsum("bskgd,blkd->bkgsl", q, k)
    old = raw * (torch.tensor(head_dim, dtype=torch.float32) ** -0.5)
    new = raw * tdecode._score_scale(head_dim)
    assert new.dtype == torch.float32
    assert torch.equal(new.view(torch.int32), old.view(torch.int32))
    ref = np.asarray(jnp.asarray(head_dim, jnp.float32) ** -0.5)
    assert np.float32(tdecode._score_scale(head_dim)).view(np.uint32) == (
        ref.view(np.uint32))
    assert float(np.float32(tdecode._score_scale(head_dim))) == (
        tdecode._score_scale(head_dim))  # exact in f32


# ---- sampling (queue 1 item 5.7) --------------------------------------------

JKEY = jax.random.PRNGKey(2)
KEY = np.asarray(JKEY)  # the same key, as the port takes it


def _stream_key(rid: int):
    return jax.random.fold_in(jax.random.fold_in(JKEY, 1), rid)


class _Replaying:
    """The graphs' CPU stand-in (tests/test_torch_graphs.py): the warm-up
    runs the step, a capture records it without running it, a replay runs
    it."""

    def warm_up(self, body):
        body()

    def capture(self, body):
        return body

    def replay(self, graph):
        graph()


@pytest.mark.parametrize("case", [
    (False, {}, {}),
    (True, {"top_k": 8}, {"key": JKEY}),
    (False, {"top_p": 0.9}, {"key": JKEY, "rows": True}),
    (True, {"top_k": 5, "top_p": 0.8}, {"key": JKEY, "rows": True}),
], ids=["default_key", "top_k-int8kv", "top_p-row_keys",
        "both-row_keys-int8kv"])
def test_sampled_generate_equals_reference(case):
    """test_decode.py:69-110: the split chain (the default key, and an
    explicit one) and per-row keys with offsets, the einsum path and K5's
    plain version (kv_kernel AUTO, with kv_quant): the reference's
    tokens."""
    kv_quant, filters, extra = case
    jcfg, tcfg, jparams, tparams = _setup()
    prompt = np.random.default_rng(1).integers(1, 64, (3, 7)).astype(
        np.int32)
    if extra.get("rows"):
        extra = {"key": JKEY, "row_key_offsets": np.array([0, 5, 9],
                                                         np.int32),
                 "row_keys": jnp.stack([jax.random.fold_in(JKEY, i)
                                        for i in range(3)])}
    want = jdecode.generate(jparams, jnp.asarray(prompt), jcfg, 9,
                            temperature=0.8, kv_quant=kv_quant, **filters,
                            **extra)
    got = tdecode.generate(tparams, prompt, tcfg, 9, temperature=0.8,
                           kv_quant=kv_quant, device="cpu", **filters,
                           **{k: np.asarray(v) for k, v in extra.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_determinism_and_top_k_1_is_greedy():
    """test_decode.py:69 and :103: the same key gives the same tokens, and
    top_k 1 leaves only the argmax whatever the temperature."""
    _, tcfg, _, tparams = _setup()
    prompt = [[3, 9, 1, 4], [7, 7, 2, 5]]
    a = tdecode.generate(tparams, prompt, tcfg, 6, temperature=1.0,
                         key=KEY, device="cpu")
    b = tdecode.generate(tparams, prompt, tcfg, 6, temperature=1.0,
                         key=KEY, device="cpu")
    assert torch.equal(a, b)
    greedy = tdecode.generate(tparams, prompt, tcfg, 6, device="cpu")
    k1 = tdecode.generate(tparams, prompt, tcfg, 6, temperature=1.0,
                          key=np.asarray(jax.random.PRNGKey(1)), top_k=1,
                          device="cpu")
    assert torch.equal(k1, greedy)


@pytest.mark.parametrize("rows", [False, True], ids=["chain", "row_keys"])
def test_sampled_generate_graph_step_equals_eager(monkeypatch, rows):
    """generate's captured step samples from its static key chain (or row
    keys and offsets): through the graphs' CPU stand-in (warm-up, capture,
    replays) the tokens equal the eager loop's."""
    _, tcfg, _, tparams = _setup()
    prompt = [[3, 9, 1, 4], [7, 7, 2, 5]]
    kw = dict(temperature=0.9, top_k=10, top_p=0.9, key=KEY,
              kv_quant=True, device="cpu")
    if rows:
        kw.update(row_keys=np.asarray(jnp.stack([_stream_key(0),
                                                 _stream_key(1)])),
                  row_key_offsets=[3, 0])
    want = tdecode.generate(tparams, prompt, tcfg, 8, **kw)
    made = []

    def for_device(device):
        made.append(graphs.StepGraphs(_Replaying()))
        return made[-1]

    monkeypatch.setattr(graphs, "for_device", for_device)
    got = tdecode.generate(tparams, prompt, tcfg, 8, **kw)
    assert torch.equal(got, want)
    assert made[0].stats["captured"] == 1 and made[0].stats["replays"] == 6


@pytest.mark.parametrize("filters", [(0, 1.0), (50, 1.0), (0, 0.95),
                                     (50, 0.95)],
                         ids=["none", "top_k", "top_p", "both"])
def test_pick_margin_bounds_the_shift_that_changes_a_draw(filters):
    """decode._pick_margin, the sampled near-tie measure chip_smoke.py
    judges divergences by: whenever logits shifted by at most d (each
    entry) draw another token with the same gumbel noise, the margin of
    the unshifted pick is at most 2 d. Near-uniform logits over a
    vocabulary of 512, as a random model's are, put the filters' cutoffs
    close together, so many trials flip."""
    top_k, top_p = filters
    gen = torch.Generator().manual_seed(0)
    flips = 0
    for trial in range(300):
        logits = torch.randn(512, generator=gen) * 0.3
        g = prng.gumbel(prng.key(trial), (512,))
        d = 0.05
        shift = (torch.rand(512, generator=gen) * 2 - 1) * d
        pick = lambda lg: int(torch.argmax(  # noqa: E731
            tdecode._filter_logits(lg / 0.8, top_k, top_p) + g))
        if pick(logits) != pick(logits + shift):
            flips += 1
            assert tdecode._pick_margin(logits, g, 0.8, top_k,
                                        top_p) <= 2 * d + 1e-6, trial
    assert flips > 0
