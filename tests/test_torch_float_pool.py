"""The paged engine's gathered-window route in the port (queue 1 item 8:
tpu_bootstrap_torch/workload/serving.py: PagedPool(kv_quant=False), the
float KV pool, and ``paged_kernel`` with the reference's rule, ``_paged_chunk``
over ``_gather_windows`` / ``_window_scan`` / ``_scatter_windows``) held to
the JAX reference on the CPU.

Across the frameworks: the routing rule and its refusals; the float pool's
streams equal the reference's (greedy ones may part only at a near-tie,
tests/test_torch_decode.py:NEAR_TIE, judged by the port's solo logits on
the float cache; sampled ones are held exactly, f32), and so do its stats;
tests/test_torch_scheduler.py's differential steps both packages' Scheduler
+ float PagedPool through growth, preemption and both resume arms,
comparing the whole state after every step, exactly.

Within the port, in f32 and exactly, on the float pool: paged == resident ==
solo ``generate(kv_kernel=False)`` (greedy, sampled and speculative); the
kernel route equals the gathered route on one int8 pool; preempted,
swapped-and-restored (promoted bytes bitwise the demoted), crash-recovered
and prefix-cached streams equal the undisturbed ones.

Mirrors test_paged.py:61, :77, :252, :267 and :285, test_paged_kernel.py:49
and :103 (the pool's half; the kernel's own in
tests/test_torch_decode_attention.py), and the float cases of
test_scheduler.py:168, test_host_tier.py:120, test_faults.py:257 and
test_prefix_cache.py:352 and :411."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_decode import assert_greedy_equal
from tests.test_torch_scheduler import JCFG as SJCFG
from tests.test_torch_scheduler import JPARAMS as SJPARAMS
from tests.test_torch_scheduler import TCFG as STCFG
from tests.test_torch_scheduler import TPARAMS as STPARAMS
from tests.test_torch_scheduler import (  # noqa: F401 - a fixture
    PINNED_GBPS,
    _differential,
    _drive,
    _specs,
    pinned_cost,
)
from tpu_bootstrap import telemetry as jtelemetry
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import bridge, faults, prng
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import decode_attention as tda
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

CPU = {"device": "cpu"}


def _models(base: dict, seed: int):
    jcfg, tcfg = jmodel.ModelConfig(**base), tmodel.ModelConfig(**base)
    jparams = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


# test_paged.py:28's TINY, float weights, at its own head dim 8, which K2
# does not take: the port's int8 pool routes it to the gathered route.
TINY_BASE = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=8,
                 embed_dim=16, mlp_dim=32, max_seq_len=64)
JTINY, TTINY, JTP, TTP = _models(TINY_BASE, 1)
# test_paged.py:25's CFG at the port's smallest K2 head dim (16), float
# weights, and their int8 copy (the speculative draft).
CFG_BASE = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
                embed_dim=32, mlp_dim=64, max_seq_len=64)
JCFG, TCFG, JP, TP = _models(CFG_BASE, 0)
JDRAFT = jquant.quantize_params(JP)
TDRAFT = bridge.params_from_numpy(jax.tree.map(np.asarray, JDRAFT),
                                  device="cpu")


def _solo(params, cfg, tokens, max_new, kv_quant=False):
    return tdecode.generate(params, [tokens], cfg, max_new,
                            kv_quant=kv_quant, kv_kernel=False,
                            device="cpu")[0].tolist()


def _rspecs(n, seed=0, vocab=64, max_prompt=9, max_budget=13):
    """test_paged.py:38's requests, as (rid, tokens, max_new)."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, vocab, int(rng.integers(2, max_prompt))
                             ).tolist(), int(rng.integers(1, max_budget)))
            for i in range(n)]


def _reqs(mod, specs):
    return [mod.Request(rid=s[0], tokens=s[1], max_new=s[2]) for s in specs]


def _drain(pool):
    got = {}
    while pool.has_active():
        for rid, ev in pool.step_round().items():
            if ev["done"]:
                got[rid] = ev["generated"]
    return got


# ---- the float pool against the reference and within the port -------------


def test_paged_matches_solo_and_resident_small():
    """test_paged.py:61 on the float pool: the reference's streams and
    stats, and within the port paged == resident == solo; chunked prefill
    covers every prompt token but the re-fed last one, once."""
    specs = _rspecs(6, seed=3, vocab=32)
    kw = dict(paged=True, block_size=8, prefill_budget=4)
    want_stats, pstats = {}, {}
    want = jserving.serve(JTP, JTINY, _reqs(jserving, specs), 3,
                          stats=want_stats, **kw)
    pg = tserving.serve(TTP, TTINY, _reqs(tserving, specs), 3, stats=pstats,
                        **kw, **CPU)
    rs = tserving.serve(TTP, TTINY, _reqs(tserving, specs), 3, resident=True,
                        **CPU)
    assert pg == rs
    for i, t, m in specs:
        assert pg[i] == _solo(TTP, TTINY, t, m), i
    assert_greedy_equal(pg, want, {i: t for i, t, _ in specs}, TTP, TTINY,
                        kv_quant=False)
    for key in want_stats:
        if key != "scheduler":
            assert pstats[key] == want_stats[key], key
    assert pstats["prefill_tokens"] == sum(len(t) - 1 for _, t, _ in specs)
    assert pstats["blocks_peak"] >= 1
    assert pstats["blocks_total"] == 3 * (64 // 8)


def test_paged_capacity_beats_resident_at_equal_kv_memory():
    """test_paged.py:77: at equal KV memory the paged engine admits at
    least 3x the cap-length resident pool's requests."""
    cap_base = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
                    embed_dim=16, mlp_dim=32, max_seq_len=128)
    _, cap_cfg, _, params = _models(cap_base, 2)
    rng = np.random.default_rng(7)
    reqs = [tserving.Request(rid=i, tokens=rng.integers(1, 64, 8).tolist(),
                             max_new=int(rng.choice([4, 8, 16, 32])))
            for i in range(64)]
    resident_slots, bs = 2, 16
    res = tserving.ResidentPool(params, cap_cfg, resident_slots, **CPU)
    paged = tserving.PagedPool(params, cap_cfg, batch_size=64,
                               kv_blocks=resident_slots * (128 // bs),
                               block_size=bs, **CPU)
    assert (paged.allocator.num_blocks * bs
            == resident_slots * cap_cfg.max_seq_len)
    assert sum(a.numel() * a.element_size() for layer in paged.pools
               for a in layer.values()) == (
        (paged.allocator.num_blocks + 1) * bs * 2 * 2 * 8 * 4)
    admitted_res = admitted_paged = 0
    for r in reqs:
        if res.admits(r):
            res.admit(r)
            admitted_res += 1
    for r in reqs:
        if paged.admits(r):
            paged.admit(r)
            admitted_paged += 1
    assert admitted_res == resident_slots
    assert admitted_paged >= 3 * admitted_res, (admitted_paged, admitted_res)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_parity_matrix_greedy(kv_quant):
    """test_paged.py:252: paged == resident, and == solo generate; the
    float pool on the gathered route, the int8 pool on K2's plain
    version. The reference's float-pool streams up to near-ties."""
    specs = _rspecs(10, seed=17)
    pstats: dict = {}
    kw = dict(kv_quant=kv_quant, **CPU)
    pg = tserving.serve(TP, TCFG, _reqs(tserving, specs), 4, paged=True,
                        block_size=8, prefill_budget=8, stats=pstats, **kw)
    rs = tserving.serve(TP, TCFG, _reqs(tserving, specs), 4, resident=True,
                        **kw)
    assert pg == rs
    for i, t, m in specs:
        assert pg[i] == _solo(TP, TCFG, t, m, kv_quant), i
    assert pstats["rounds"] > 1
    if not kv_quant:
        want = jserving.serve(JP, JCFG, _reqs(jserving, specs), 4,
                              paged=True, block_size=8, prefill_budget=8)
        assert_greedy_equal(pg, want, {i: t for i, t, _ in specs}, TP, TCFG,
                            kv_quant=False)


def test_paged_sampled_streams_match_resident_and_solo():
    """test_paged.py:267 on the float pool: paged == resident (another
    batch) == solo with the request's row key == the reference's paged
    streams, exactly."""
    key = np.asarray(jax.random.PRNGKey(29))
    specs = _rspecs(6, seed=19)
    kw = dict(temperature=0.9, top_k=20, key=key, **CPU)
    pg = tserving.serve(TP, TCFG, _reqs(tserving, specs), 3, paged=True,
                        block_size=8, prefill_budget=4, **kw)
    rs = tserving.serve(TP, TCFG, _reqs(tserving, specs), 2, resident=True,
                        **kw)
    assert pg == rs
    want = jserving.serve(JP, JCFG, _reqs(jserving, specs), 3, paged=True,
                          block_size=8, prefill_budget=4, temperature=0.9,
                          top_k=20, key=jax.random.PRNGKey(29))
    assert pg == want
    pkey = prng.as_key(key, "cpu")
    for i, t, m in specs[:2]:
        row_key = prng.fold_in(prng.fold_in(pkey, 1), i)
        solo = tdecode.generate(TP, [t], TCFG, m, temperature=0.9, top_k=20,
                                row_keys=row_key[None],
                                row_key_offsets=torch.zeros(
                                    1, dtype=torch.long), device="cpu")
        assert pg[i] == solo[0].tolist(), i


def test_paged_speculative_commits_per_row_and_bit_matches():
    """test_paged.py:285 on the float pool: an int8 draft, gamma 3, each
    row committing its own count; paged == resident == solo; the phase
    timers observed every verify round."""
    specs = _rspecs(8, seed=23)
    stats: dict = {}
    kw = dict(draft_params=TDRAFT, draft_cfg=TCFG, gamma=3, **CPU)
    before = telemetry.metrics().to_json()
    pg = tserving.serve(TP, TCFG, _reqs(tserving, specs), 4, paged=True,
                        block_size=8, prefill_budget=8, stats=stats, **kw)
    after = telemetry.metrics().to_json()
    rs = tserving.serve(TP, TCFG, _reqs(tserving, specs), 4, resident=True,
                        **kw)
    assert pg == rs
    for i, t, m in specs:
        assert pg[i] == _solo(TP, TCFG, t, m), i
    assert stats["committed_tokens"] == sum(len(v) for v in pg.values())
    assert stats["committed_tokens"] / stats["verify_rounds"] > 1.0
    for name in ("serve_spec_draft_ms", "serve_spec_verify_ms",
                 "serve_spec_commit_ms"):
        assert (after[f"{name}_count"] - before.get(f"{name}_count", 0)
                == stats["verify_rounds"]), name


# ---- the routing rule: the kernel route or the gathered route -------------


def test_kernel_route_equals_gathered_route(monkeypatch):
    """test_paged_kernel.py:103: on one int8 pool, AUTO takes K2 at a
    block it tiles, every decode chunk streaming through it, and
    ``paged_kernel=False`` never calls it; the tokens and every written
    pool byte of the two routes are equal (K2's plain version and the
    einsums)."""
    reqs = [(0, [3, 1, 4, 1, 5], 6), (1, [2, 7], 4), (2, [9, 9, 8], 11)]
    calls = {"n": 0}
    real = tda.paged_decode_attention_int8

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tda, "paged_decode_attention_int8", counting)

    def run(**kw):
        pool = tserving.PagedPool(TP, TCFG, 3, kv_quant=True, block_size=8,
                                  prefix_cache=False, **kw, **CPU)
        assert pool.paged_kernel == (not kw)
        assert pool.snapshot()["paged_kernel"] == (not kw)
        assert (pool._graphs is None) if kw else True
        for r in _reqs(tserving, reqs):
            pool.admit(r)
        return _drain(pool), pool

    with_kernel, kpool = run()
    assert calls["n"] > 0, "the kernel route never called K2"
    calls["n"] = 0
    without, gpool = run(paged_kernel=False)
    assert calls["n"] == 0, "paged_kernel=False still called K2"
    assert with_kernel == without
    for i, t, m in reqs:
        assert without[i] == _solo(TP, TCFG, t, m, kv_quant=True), i
    # Every block but the null one (id 0), which both routes' dummy and
    # padding writes fill with garbage no mask admits.
    for kl, gl in zip(kpool.pools, gpool.pools):
        for n in kl:
            assert torch.equal(kl[n][1:], gl[n][1:]), n


ROUTES = {
    # name: (cfg, pool kwargs, the port's paged_kernel or the refusal)
    "int8_tiled_auto": ("cfg", {"kv_quant": True, "block_size": 8}, True),
    "int8_forced_off": ("cfg", {"kv_quant": True, "block_size": 8,
                                "paged_kernel": False}, False),
    "float_auto": ("cfg", {"kv_quant": False, "block_size": 8}, False),
    "float_forced_on": ("cfg", {"kv_quant": False, "block_size": 8,
                                "paged_kernel": True},
                        "requires kv_quant=True"),
    # Head dim 8: K2 takes multiples of 16 (the reference's kernel tiles it).
    "int8_untiled_auto": ("tiny", {"kv_quant": True, "block_size": 8},
                          False),
    "int8_untiled_forced_on": ("tiny", {"kv_quant": True, "block_size": 8,
                                        "paged_kernel": True},
                               "paged_supports"),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_paged_kernel_routing_rule(name):
    """The reference's ``paged_kernel`` rule (None: a quantized pool at a
    block the kernel tiles; True on a float pool or an untileable block
    raises the reference's ValueError), on the port's own
    ``paged_supports``. Where the two kernels' limits agree, the reference
    routes the same way, or refuses with the same message."""
    which, kw, want = ROUTES[name]
    params, cfg, jparams, jcfg = ((TP, TCFG, JP, JCFG) if which == "cfg"
                                  else (TTP, TTINY, JTP, JTINY))
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tserving.PagedPool(params, cfg, 2, **kw, **CPU)
        if which == "cfg":
            with pytest.raises(ValueError, match=want):
                jserving.PagedPool(jparams, jcfg, 2, **kw)
        return
    pool = tserving.PagedPool(params, cfg, 2, **kw, **CPU)
    assert pool.paged_kernel is want
    assert pool.snapshot()["paged_kernel"] is want
    names = set(pool.pools[0])
    assert names == ({"k", "k_scale", "v", "v_scale"} if kw["kv_quant"]
                     else {"k", "v"})
    if which == "cfg":
        assert jserving.PagedPool(jparams, jcfg, 2, **kw).paged_kernel is want
    pool.admit(tserving.Request(rid=0, tokens=[5, 9, 2], max_new=5))
    assert _drain(pool)[0] == _solo(params, cfg, [5, 9, 2], 5,
                                    kv_quant=kw["kv_quant"])


def test_untiled_int8_pool_streams_equal_reference_kernel_route():
    """The reference's kernel route on a head dim the port's K2 does not
    take, against the port's gathered route on the same int8 pool: the
    same streams up to near-ties, the same stats."""
    specs = _rspecs(6, seed=5, vocab=32)
    kw = dict(paged=True, kv_quant=True, block_size=8, prefill_budget=4)
    want_stats, stats = {}, {}
    want = jserving.serve(JTP, JTINY, _reqs(jserving, specs), 3,
                          stats=want_stats, **kw)
    got = tserving.serve(TTP, TTINY, _reqs(tserving, specs), 3, stats=stats,
                         **kw, **CPU)
    assert_greedy_equal(got, want, {i: t for i, t, _ in specs}, TTP, TTINY,
                        kv_quant=True)
    for key in want_stats:
        if key != "scheduler":
            assert stats[key] == want_stats[key], key


# ---- the float pool under pressure: the scheduler, the host tier, faults --


@pytest.mark.parametrize("name", ["tight_tier_on", "refusal"])
def test_float_pool_scheduler_differential_against_reference(
        name, pinned_cost, monkeypatch):
    """test_scheduler.py:168's float pool, stepped beside the reference's
    (tests/test_torch_scheduler.py's differential): growth, capacity
    preemptions and both resume arms on a tight pool, or refusal
    admission; the whole state equal after every step, the streams equal
    solo generate on the float cache. A float token moves more bytes than
    an int8 one, so the pinned link is as much faster: short victims
    recompute and long ones swap, as on the int8 pool."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", repr(
        PINNED_GBPS * tmodel.kv_bytes_per_token(STCFG, False)
        / tmodel.kv_bytes_per_token(STCFG, True)))
    cases = {
        "tight_tier_on": (_specs(8, seed=7), dict(
            batch_size=8, block_size=8, kv_blocks=8, prefill_budget=4,
            host_blocks=64), dict(overcommit=True, expected_new=2)),
        "refusal": (_specs(8, seed=5), dict(
            batch_size=4, block_size=8, kv_blocks=12, prefill_budget=4),
            dict(overcommit=False)),
    }
    specs, pool_kw, sched_kw = cases[name]
    done, pool, sched, log = _differential(specs, pool_kw, sched_kw,
                                           kv_quant=False)
    assert not pool.kv_quant and not pool.paged_kernel
    assert set(done) == {i for i, *_ in specs}
    for i, t, m, _p in specs:
        assert done[i] == _solo(STPARAMS, STCFG, t, m), i
    arms = {e[2] for e in log if e[0] == "arm"}
    if name == "tight_tier_on":
        assert arms == {"swap", "recompute"}
        assert sched.stats["requeues"] == pool.stats["preemptions"] > 0


def _sreqs(specs):
    return [tserving.Request(rid=i, tokens=t, max_new=m, priority=p)
            for i, t, m, p in specs]


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("sampled", [False, True])
def test_preempted_streams_byte_identical(prefix_cache, sampled):
    """test_scheduler.py:168, kv_quant=False: a tight pool under
    overcommit preempts, and every preempted-then-resumed stream equals
    the unpressured one, greedy and sampled, prefix cache on or off."""
    reqs = _sreqs(_specs(8, seed=7))
    kw = {}
    if sampled:
        kw = {"temperature": 0.8, "top_k": 8,
              "key": np.asarray(jax.random.PRNGKey(2))}
    roomy = tserving.serve(STPARAMS, STCFG, reqs, 8, paged=True,
                           block_size=8, prefill_budget=4,
                           prefix_cache=prefix_cache, **kw, **CPU)
    pool = tserving.PagedPool(STPARAMS, STCFG, 8, block_size=8, kv_blocks=8,
                              prefill_budget=4, prefix_cache=prefix_cache,
                              **kw, **CPU)
    sched = tserving.Scheduler(pool, overcommit=True, expected_new=2)
    tight = _drive(pool, sched, reqs)
    assert pool.stats["preemptions"] > 0, "pool was not actually tight"
    assert sched.stats["requeues"] == pool.stats["preemptions"]
    assert tight == roomy
    if not sampled:
        for r in reqs:
            assert tight[r.rid] == _solo(STPARAMS, STCFG, r.tokens,
                                         r.max_new), r.rid


def test_swap_restore_streams_byte_identical(monkeypatch):
    """test_host_tier.py:120, kv_quant=False: a generous link makes every
    victim swap; the streams equal the tier-off run's; then the float
    blocks' bytes: every demoted payload is the block's K and V, and a
    promoted block holds its payload bitwise, written in place."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    monkeypatch.setenv("TPUBC_EXPECTED_NEW", "2")
    reqs = _sreqs(_specs(8, seed=11))
    kw = dict(paged=True, block_size=8, kv_blocks=8, prefill_budget=4,
              overcommit=True, **CPU)
    swapped: dict = {}
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "64")
    on = tserving.serve(STPARAMS, STCFG, reqs, 8, stats=swapped, **kw)
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")
    off = tserving.serve(STPARAMS, STCFG, reqs, 8, **kw)
    assert on == off
    assert swapped["preemptions"] > 0 and swapped["swap_preempts"] > 0

    prompt = np.random.default_rng(17).integers(1, 32, 20).tolist()
    pool = tserving.PagedPool(STPARAMS, STCFG, 2, block_size=8, kv_blocks=16,
                              prefill_budget=8, host_blocks=16, **CPU)
    pool.admit(tserving.Request(rid=1, tokens=prompt, max_new=6))
    first = _drain(pool)[1]
    cached = dict(pool.allocator._cached)
    before = {k: [{n: a[b].clone() for n, a in layer.items()}
                  for layer in pool.pools] for b, k in cached.items()}
    ptrs = [a.data_ptr() for layer in pool.pools for a in layer.values()]
    assert pool.demote_lru(pool.allocator.cached()) == len(cached) > 0
    for k, layers in before.items():
        entry = pool.host.get(k)
        for li, layer in enumerate(layers):
            assert set(layer) == {"k", "v"}
            for n, t in layer.items():
                assert torch.equal(entry["t"][li][n], t), n
    payload = {k: pool.host.get(k) for k in pool.host.keys()}
    plan, _cow, _ = pool._prefix_plan(prompt)
    assert plan and all(tier == "host" for tier, _b, _k in plan)
    pool.admit(tserving.Request(rid=2, tokens=prompt, max_new=6))
    s = next(s for s in pool.slots if s is not None)
    for j, (_tier, _b, k) in enumerate(plan):
        for li, layer in enumerate(pool.pools):
            for n, a in layer.items():
                assert torch.equal(a[s.blocks[j]], payload[k]["t"][li][n]), n
    assert ptrs == [a.data_ptr() for layer in pool.pools
                    for a in layer.values()]
    assert _drain(pool)[2] == first == _solo(STPARAMS, STCFG, prompt, 6)


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("sampled", [False, True])
def test_crash_recovery_byte_identity(prefix_cache, sampled):
    """test_faults.py:257, kv_quant=False: two device aborts and an
    allocator breach mid-burst, every recovered stream equal to the
    fault-free run (and, greedy, to solo generate)."""
    reqs = _sreqs(_specs(6, seed=7))
    kw = dict(paged=True, block_size=8, prefill_budget=4,
              prefix_cache=prefix_cache, **CPU)
    if sampled:
        kw.update(temperature=0.8, top_k=8,
                  key=np.asarray(jax.random.PRNGKey(7)))
    clean = tserving.serve(STPARAMS, STCFG, reqs, 4, **kw)
    inj = faults.install("pool.device:1:2,pool.device:1:6,alloc:1:4")
    stats: dict = {}
    try:
        faulted = tserving.serve(STPARAMS, STCFG, reqs, 4, stats=stats, **kw)
        fired = inj.stats()["fired"]
    finally:
        faults.install(None)
    assert fired.get("pool.device") == 2 and fired.get("alloc") == 1, fired
    assert stats["scheduler"]["recoveries"] == 3
    assert faulted == clean
    if not sampled:
        for r in reqs:
            assert faulted[r.rid] == _solo(STPARAMS, STCFG, r.tokens,
                                           r.max_new), r.rid


# ---- the prefix cache on the float pool ------------------------------------


def _shared_prefix_specs(n, sys_len=24, tail=4, max_new=6, seed=0, vocab=32):
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, sys_len).tolist()
    return [(i, sysp + rng.integers(1, vocab, tail).tolist(), max_new)
            for i in range(n)]


def test_cached_equals_cold_equals_resident_greedy():
    """test_prefix_cache.py:352 (the reference's default float pool):
    cached == cold == resident == solo, while hitting the cache; the
    cached streams and the cache's stats equal the reference's."""
    specs = _shared_prefix_specs(6, sys_len=24, tail=4, max_new=6, seed=11)
    kw = dict(paged=True, block_size=8, prefill_budget=8)
    stats, want_stats = {}, {}
    warm = tserving.serve(STPARAMS, STCFG, _reqs(tserving, specs), 3,
                          stats=stats, **kw, **CPU)
    cold = tserving.serve(STPARAMS, STCFG, _reqs(tserving, specs), 3,
                          prefix_cache=False, **kw, **CPU)
    res = tserving.serve(STPARAMS, STCFG, _reqs(tserving, specs), 3,
                         resident=True, **CPU)
    assert warm == cold == res
    for i, t, m in specs:
        assert warm[i] == _solo(STPARAMS, STCFG, t, m), i
    assert stats["prefix_hit_tokens"] > 0
    assert stats["prefix_hit_requests"] >= 3
    want = jserving.serve(SJPARAMS, SJCFG, _reqs(jserving, specs), 3,
                          stats=want_stats, **kw)
    assert_greedy_equal(warm, want, {i: t for i, t, _ in specs}, STPARAMS,
                        STCFG, kv_quant=False)
    for key in ("prefill_tokens", "prompt_tokens", "prefix_hit_tokens",
                "prefix_hit_requests", "cow_copies", "blocks_peak"):
        assert stats[key] == want_stats[key], key


@pytest.mark.parametrize("kv_quant", [False, True])
def test_cached_matrix_greedy(kv_quant):
    """test_prefix_cache.py:411: cached == cold == resident, and == solo
    generate, on the float and the int8 pool."""
    specs = _shared_prefix_specs(10, sys_len=24, tail=5, max_new=8, seed=17,
                                 vocab=64)
    kw = dict(kv_quant=kv_quant, **CPU)
    warm = tserving.serve(TP, TCFG, _reqs(tserving, specs), 4, paged=True,
                          block_size=8, prefill_budget=8, **kw)
    cold = tserving.serve(TP, TCFG, _reqs(tserving, specs), 4, paged=True,
                          block_size=8, prefill_budget=8, prefix_cache=False,
                          **kw)
    res = tserving.serve(TP, TCFG, _reqs(tserving, specs), 4, resident=True,
                         **kw)
    assert warm == cold == res
    for i, t, m in specs:
        assert warm[i] == _solo(TP, TCFG, t, m, kv_quant), i


def test_float_pool_ledger_kv_bytes_follow_the_float_cache():
    """The swap arm's price and the KV gauges use the float cache's bytes
    a token (kv_bytes_per_token(cfg, False)), as the reference's."""
    for kv_quant in (False, True):
        pool = tserving.PagedPool(STPARAMS, STCFG, 2, block_size=8,
                                  kv_quant=kv_quant, **CPU)
        ref = jserving.PagedPool(SJPARAMS, SJCFG, 2, block_size=8,
                                 kv_quant=kv_quant)
        assert pool._kv_bytes_per_tok == ref._kv_bytes_per_tok == (
            tmodel.kv_bytes_per_token(STCFG, kv_quant))
        pool.admit(tserving.Request(rid=0, tokens=[1, 2, 3, 4, 5],
                                    max_new=3))
        pool._record_block_gauges()
        js = telemetry.metrics().to_json()
        ref.admit(jserving.Request(rid=0, tokens=[1, 2, 3, 4, 5], max_new=3))
        ref._record_block_gauges()
        jjs = jtelemetry.metrics().to_json()
        for name in js:
            if name.startswith("kv_") and "bytes" in name and name in jjs:
                assert js[name] == jjs[name], name
