"""Greedy speculative decoding in the port
(tpu_bootstrap_torch/workload/speculative.py), mirroring the reference's
tests/test_speculative.py on the CPU: every committed token is the
target's own greedy choice, so the output equals the port's
generate(kv_kernel=False) and the reference's speculative_generate on the
same bridged weights, whatever the draft; full acceptance when the draft
is the target; the int8 KV path, where the draft's single-query steps run
K5's plain version; ragged prompts; the acceptance statistics against the
reference's; and the rejection of bad arguments. Then sampled
speculative decoding (test_speculative.py:106-170): the rejection scheme's
tokens and rounds equal the reference's on its keys, the second token's
marginal matches the target's, a draft that is the target accepts every
proposal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import speculative as jspec
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import decode_attention as tda
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import prng
from tpu_bootstrap_torch.workload import quant as tquant
from tpu_bootstrap_torch.workload import speculative as tspec

torch.set_num_threads(2)

# The reference test's shapes with head_dim 16, the port's smallest K5
# head dim (16-byte loads), so its draft steps can take the kernel path.
TARGET = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
              embed_dim=32, mlp_dim=64, max_seq_len=128)
DRAFT = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=16,
             embed_dim=16, mlp_dim=32, max_seq_len=128)


def _bridge(params):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                    device="cpu")


@pytest.fixture(scope="module")
def models():
    """Reference and port configs and params (target and an untrained
    draft from the reference's init), and a (3, 7) prompt."""
    jt, jd = jmodel.ModelConfig(**TARGET), jmodel.ModelConfig(**DRAFT)
    target = jmodel.init_params(jt, jax.random.PRNGKey(0))
    draft = jmodel.init_params(jd, jax.random.PRNGKey(1))
    prompt = np.random.default_rng(2).integers(0, 64, (3, 7)).astype(np.int32)
    return {"jcfg": (jt, jd), "jparams": (target, draft),
            "tcfg": (tmodel.ModelConfig(**TARGET),
                     tmodel.ModelConfig(**DRAFT)),
            "tparams": (_bridge(target), _bridge(draft)), "prompt": prompt}


def _generate(models, steps, **kw):
    tcfg = models["tcfg"][0]
    return tdecode.generate(models["tparams"][0], models["prompt"], tcfg,
                            steps, kv_kernel=False, device="cpu", **kw)


@pytest.mark.parametrize("gamma", [1, 3, 4])
def test_exact_greedy_equivalence_random_draft(models, gamma):
    """An untrained draft (near-zero acceptance) still yields the target's
    greedy tokens: equal to the port's generate and to the reference's
    speculative_generate, rounds and all."""
    (tt, td), (pt, pd) = models["tcfg"], models["tparams"]
    got, stats = tspec.speculative_generate(
        pt, pd, models["prompt"], tt, td, 20, gamma=gamma, with_stats=True,
        device="cpu")
    assert torch.equal(got, _generate(models, 20))
    (jt, jd), (jpt, jpd) = models["jcfg"], models["jparams"]
    want, jstats = jspec.speculative_generate(
        jpt, jpd, jnp.asarray(models["prompt"]), jt, jd, 20, gamma=gamma,
        with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["verify_rounds"] == int(jstats["verify_rounds"])
    assert np.float32(stats["mean_committed"]) == jstats["mean_committed"]


def test_exact_equivalence_draft_is_target(models):
    """Draft == target: every proposal is accepted, so every round commits
    gamma + 1 (the draft-cache-hole guard: a missing KV slot after a
    full-acceptance round would lower later acceptance)."""
    (tt, _), (pt, _) = models["tcfg"], models["tparams"]
    steps, gamma = 41, 4
    got, stats = tspec.speculative_generate(
        pt, pt, models["prompt"], tt, tt, steps, gamma=gamma,
        with_stats=True, device="cpu")
    assert torch.equal(got, _generate(models, steps))
    assert stats["verify_rounds"] == (steps - 1 + gamma) // (gamma + 1)
    assert stats["mean_committed"] == gamma + 1


def test_exact_equivalence_int8_kv(models, monkeypatch):
    """kv_quant: both models on int8 caches; the target's chunks take the
    einsum path and the draft's single-query steps K5's plain version
    (counted: gamma + 1 steps a round, every layer), and the output equals
    generate(kv_kernel=False). steps=25 makes generate's cache 7 + 25 = 32,
    where AUTO would take the kernel, so kv_kernel=False is the oracle."""
    (tt, td), (pt, pd) = models["tcfg"], models["tparams"]
    calls = {"n": 0}
    real = tda.decode_attention_int8

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tda, "decode_attention_int8", counting)
    got, stats = tspec.speculative_generate(
        pt, pd, models["prompt"], tt, td, 25, gamma=3, kv_quant=True,
        with_stats=True, device="cpu")
    assert calls["n"] == stats["verify_rounds"] * 4 * DRAFT["num_layers"]
    monkeypatch.setattr(tda, "decode_attention_int8", real)
    assert torch.equal(got, _generate(models, 25, kv_quant=True))
    calls["n"] = 0
    monkeypatch.setattr(tda, "decode_attention_int8", counting)
    tspec.speculative_generate(pt, pd, models["prompt"], tt, td, 25,
                               gamma=3, kv_quant=True, kv_kernel=False,
                               device="cpu")
    assert calls["n"] == 0


def test_self_speculation_int8_draft_accepts(models):
    """The serving recipe: the target's int8 copy as its own draft
    accepts far more than a random draft, and the output is still the
    float target's greedy path."""
    (tt, td), (pt, pd) = models["tcfg"], models["tparams"]
    draft = tquant.quantize_params(pt)
    got, stats = tspec.speculative_generate(
        pt, draft, models["prompt"], tt, tt, 24, gamma=4, with_stats=True,
        device="cpu")
    assert torch.equal(got, _generate(models, 24))
    # The reference's bar on its toy model: clearly above a random
    # draft's ~1 commit a round.
    assert stats["mean_committed"] > 1.5, stats
    _, rand = tspec.speculative_generate(
        pt, pd, models["prompt"], tt, td, 24, gamma=4, with_stats=True,
        device="cpu")
    assert rand["mean_committed"] < stats["mean_committed"]


def test_ragged_speculative_matches_solo_greedy(models):
    """prompt_lengths (left-padded rows): each row equals its solo greedy
    generate at its true length, and the kernel is forced off."""
    (tt, _), (pt, _) = models["tcfg"], models["tparams"]
    draft = tquant.quantize_params(pt)
    rng = np.random.default_rng(1)
    lens = [3, 7, 5, 8]
    rows = [rng.integers(1, 64, n).tolist() for n in lens]
    batch = np.zeros((4, 8), np.int64)
    for i, r in enumerate(rows):
        batch[i, 8 - len(r):] = r
    out, stats = tspec.speculative_generate(
        pt, draft, batch, tt, tt, 12, gamma=3, kv_quant=True,
        with_stats=True, prompt_lengths=lens, device="cpu")
    for i, r in enumerate(rows):
        solo = tdecode.generate(pt, [r], tt, 12, kv_quant=True,
                                kv_kernel=False, device="cpu")
        assert out[i].tolist() == solo[0].tolist(), i
    assert stats["mean_committed"] > 1.0


def test_int8_kv_stats_match_reference(models):
    """Both sides with int8 caches and the draft on the kernel path: the
    cache (7 + 20 + 4 + 1 = 32 slots) is a multiple of 8, so the
    reference's supports holds and its draft takes its Pallas kernel as
    the port's takes K5. Streams equal; rounds and mean commits equal."""
    (tt, td), (pt, pd) = models["tcfg"], models["tparams"]
    (jt, jd), (jpt, jpd) = models["jcfg"], models["jparams"]
    draft = jquant.quantize_params(jpt)
    got, stats = tspec.speculative_generate(
        pt, _bridge(draft), models["prompt"], tt, tt, 20, gamma=4,
        kv_quant=True, with_stats=True, device="cpu")
    want, jstats = jspec.speculative_generate(
        jpt, draft, jnp.asarray(models["prompt"]), jt, jt, 20, gamma=4,
        kv_quant=True, with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["verify_rounds"] == int(jstats["verify_rounds"])
    assert np.float32(stats["mean_committed"]) == jstats["mean_committed"]


def test_rejects_bad_arguments(models):
    (tt, td), (pt, pd) = models["tcfg"], models["tparams"]
    prompt = models["prompt"]
    with pytest.raises(ValueError, match="steps"):
        tspec.speculative_generate(pt, pd, prompt, tt, td, 0, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        tspec.speculative_generate(pt, pd, prompt, tt, td, 4, gamma=0,
                                   device="cpu")
    odd = tmodel.ModelConfig(**{**DRAFT, "vocab_size": 32})
    with pytest.raises(ValueError, match="vocab"):
        tspec.speculative_generate(pt, pd, prompt, tt, odd, 4, device="cpu")
    with pytest.raises(ValueError, match="PRNG key"):
        tspec.speculative_generate(pt, pd, prompt, tt, td, 4,
                                   temperature=0.7, device="cpu")
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        tspec.speculative_generate(pt, pd, prompt, tt, td, 4,
                                   temperature=-0.5, device="cpu")
    with pytest.raises(ValueError, match="prompt_lengths"):
        tspec.speculative_generate(pt, pd, prompt, tt, td, 4,
                                   prompt_lengths=[7, 0, 3], device="cpu")


# ---- sampled speculative decoding (queue 1 item 5.7) ------------------------


def test_sampled_speculative_equals_reference(models):
    """The rejection scheme on the reference's keys: split(key, 4) a round,
    fold_in(draft_key, i), the uniform accept test, the resample: the same
    tokens and rounds as the reference's."""
    m = models
    (jt, jd), (tt, td) = m["jcfg"], m["tcfg"]
    (jpt, jpd), (tpt, tpd) = m["jparams"], m["tparams"]
    for seed in (100, 101):
        key = jax.random.PRNGKey(seed)
        want, wstats = jspec.speculative_generate(
            jpt, jpd, jnp.asarray(m["prompt"]), jt, jd, 10, gamma=3,
            temperature=0.8, key=key, with_stats=True)
        got, stats = tspec.speculative_generate(
            tpt, tpd, m["prompt"], tt, td, 10, gamma=3, temperature=0.8,
            key=np.asarray(key), with_stats=True, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert stats["verify_rounds"] == int(wstats["verify_rounds"])
        assert stats["mean_committed"] == pytest.approx(
            float(wstats["mean_committed"]))


def test_sampled_speculative_matches_target_distribution():
    """test_speculative.py:106: the second token's empirical marginal over
    512 seeded draws (a vocabulary of 16) is within an L1 of 0.25 of its
    exact marginal under the target alone; the same key repeats."""
    vocab, t = 16, 0.8
    tcfg = tmodel.ModelConfig(vocab_size=vocab, num_layers=1, num_heads=2,
                              head_dim=16, embed_dim=16, mlp_dim=16,
                              max_seq_len=32)
    dcfg = tmodel.ModelConfig(vocab_size=vocab, num_layers=1, num_heads=1,
                              head_dim=16, embed_dim=8, mlp_dim=8,
                              max_seq_len=32)
    target = tmodel.init_params(tcfg, seed=0, device="cpu")
    draft = tmodel.init_params(dcfg, seed=1, device="cpu")
    prompt = torch.tensor([[3, 1, 4]])
    with torch.no_grad():
        p1 = torch.softmax(tmodel.forward(target, prompt, tcfg)[0, -1] / t,
                           -1)
        ext = torch.cat([prompt.repeat(vocab, 1),
                         torch.arange(vocab)[:, None]], dim=1)
        p2 = torch.softmax(tmodel.forward(target, ext, tcfg)[:, -1] / t, -1)
    want = (p1 @ p2).numpy()
    counts = np.zeros(vocab)
    for i in range(64):
        toks = tspec.speculative_generate(
            target, draft, prompt.repeat(8, 1), tcfg, dcfg, 2, gamma=2,
            temperature=t, key=prng.key(100 + i), device="cpu")
        for tok in toks[:, 1].tolist():
            counts[tok] += 1
    got = counts / counts.sum()
    assert np.abs(got - want).sum() < 0.25, (got, want)
    a, b = (tspec.speculative_generate(target, draft, prompt.repeat(8, 1),
                                       tcfg, dcfg, 4, gamma=2, temperature=t,
                                       key=prng.key(5), device="cpu")
            for _ in range(2))
    assert torch.equal(a, b)


def test_sampled_draft_is_target_accepts_everything():
    """test_speculative.py:153: with the draft the target, every draw is
    accepted and every round commits gamma + 1."""
    cfg = tmodel.ModelConfig(vocab_size=32, num_layers=1, num_heads=2,
                             head_dim=16, embed_dim=16, mlp_dim=16,
                             max_seq_len=64)
    target = tmodel.init_params(cfg, seed=0, device="cpu")
    prompt = torch.randint(0, 32, (2, 5), generator=torch.Generator()
                           .manual_seed(2))
    _, stats = tspec.speculative_generate(target, target, prompt, cfg, cfg,
                                          21, gamma=4, temperature=1.0,
                                          key=prng.key(3), with_stats=True,
                                          device="cpu")
    assert stats["mean_committed"] == pytest.approx(5.0)
