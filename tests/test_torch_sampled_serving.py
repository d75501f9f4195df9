"""The serving engines' sampling (queue 1 item 5.7) held to the reference
on the CPU, on the same bridged int8 weights and the same pool key (a JAX
key's two uint32 words are the port's key): each request's stream draws
token k with fold_in(fold_in(fold_in(key, 1), rid), k) in the slot
engine, in the paged engine (inside its captured decode step too, through
the graphs' CPU stand-in) under preemption with swap and with recompute,
with prefix-cache hits, host-tier restores and crash recovery, through
serve and through the ingress. In f32 the streams are compared exactly.

Mirrors test_serving.py:87, test_paged.py:267, test_prefix_cache.py:427,
the sampled cases of test_scheduler.py:171, test_host_tier.py:143 and
test_ingress.py:258; the resident-engine halves (test_resident.py:139,
test_paged.py:267) are in tests/test_torch_resident.py and
tests/test_torch_float_pool.py. Sampled generate (test_decode.py:69-110) is held
in tests/test_torch_decode.py and sampled speculative decoding
(test_speculative.py:106-170) in tests/test_torch_speculative.py, which
keeps this file within a minute."""

import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_decode import _Replaying
from tests.test_torch_scheduler import (
    JCFG,
    JPARAMS,
    TCFG,
    TPARAMS,
    _differential,
    _drive,
    _reqs,
    _specs,
    pinned_cost,  # noqa: F401 - a fixture
)
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import faults, graphs
from tpu_bootstrap_torch.workload import ingress as tingress
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

SAMPLE = dict(temperature=0.8, top_k=8, top_p=0.95)
JKEY = jax.random.PRNGKey(2)
KEY = np.asarray(JKEY)  # the same key, as the port takes it


def _stream_key(rid: int):
    return jax.random.fold_in(jax.random.fold_in(JKEY, 1), rid)


# ---- the engines ------------------------------------------------------------


def _solo_sampled(spec_rid, tokens, max_new):
    return tdecode.generate(
        TPARAMS, [tokens], TCFG, max_new, kv_quant=True, kv_kernel=False,
        row_keys=np.asarray(_stream_key(spec_rid))[None],
        row_key_offsets=[0], device="cpu", **SAMPLE)[0].tolist()


def test_sampled_serving_is_scheduling_independent():
    """test_serving.py:87 on the slot engine: the same requests through
    batch 1 and through batch 3 in reverse order give the same tokens,
    equal to the reference's and to a direct generate with the request's
    stream key; a temperature without a key is refused."""
    specs = [(10 + i, t, m, 0) for i, (t, m) in enumerate(
        [([5, 9, 2], 6), ([4, 4, 1, 7, 3], 2), ([8, 1], 7),
         ([2, 6, 6, 1], 4)])]
    kw = dict(kv_quant=True, key=KEY, **SAMPLE)
    a = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 1,
                       device="cpu", **kw)
    b = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs[::-1]), 3,
                       device="cpu", **kw)
    assert a == b
    want = jserving.serve(JPARAMS, JCFG, _reqs(jserving, specs), 3,
                          **{**kw, "key": JKEY})
    assert a == want
    for rid, t, m, _p in specs:
        assert a[rid] == _solo_sampled(rid, t, m), rid
    with pytest.raises(ValueError, match="PRNG key"):
        tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 2,
                       temperature=0.7, device="cpu")


def test_paged_sampled_streams_equal_reference_and_solo():
    """test_paged.py:267: the paged engine's sampled streams (K2's plain
    version, the sampler in the decode chunk) equal the reference's paged
    engine's, the slot engine's, and each request's solo sampled generate
    with its stream key."""
    specs = _specs(5, seed=19, lo_new=3, hi_new=12)
    kw = dict(kv_quant=True, key=KEY, **SAMPLE)
    pool = dict(paged=True, block_size=8, prefill_budget=4)
    got = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 8,
                         device="cpu", **pool, **kw)
    want = jserving.serve(JPARAMS, JCFG, _reqs(jserving, specs), 8,
                          **pool, **{**kw, "key": JKEY})
    assert got == want
    assert got == tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 2,
                                 device="cpu", **kw)
    for rid, t, m, _p in specs:
        assert got[rid] == _solo_sampled(rid, t, m), rid


def test_paged_sampled_graph_step_equals_chunk_kernel(monkeypatch):
    """The sampled decode chunk through the pool's captured step (the
    row keys and offsets loaded into its static buffers) equals
    _paged_chunk_kernel with the same sampler on a clone of the pools, and
    a whole sampled serve through the graphs equals the eager one."""
    specs = _specs(5, seed=4, lo_new=3, hi_new=14)
    kw = dict(paged=True, kv_quant=True, block_size=8, prefill_budget=8,
              key=KEY, device="cpu", **SAMPLE)
    want = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 3, **kw)
    monkeypatch.setattr(graphs, "for_device",
                        lambda device: graphs.StepGraphs(_Replaying()))
    stats: dict = {}
    assert tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 3,
                          stats=stats, **kw) == want
    assert stats["graphs"]["captured"] >= 1 and stats["graphs"]["replays"]
    pool = tserving.PagedPool(TPARAMS, TCFG, 3, kv_quant=True, block_size=8,
                              prefill_budget=8, key=KEY, device="cpu",
                              **SAMPLE)
    for r in _reqs(tserving, specs[:2]):
        pool.admit(r)
    pool.step_round()
    while not pool._decoding():
        pool.step_round()
    pool.stats["rounds"] += 1
    pool._prefill_phase()
    dec = pool._decoding()
    chunk = pool._chunk_len(dec)
    bt, last, pos = pool._decode_inputs(dec, chunk)
    keys = pool._sample_keys(dec)
    twin = [{n: a.clone() for n, a in layer.items()} for layer in pool.pools]
    pool._rkeys.copy_(keys[0])
    pool._roff.copy_(keys[1])
    eager = tserving._paged_chunk_kernel(TPARAMS, twin, bt, last, pos, TCFG,
                                         chunk, pool._sampler).tolist()
    assert pool._decode_chunk(bt, last, pos, chunk, keys) == eager


def test_sampled_preemption_differential_against_reference(pinned_cost):
    """test_scheduler.py:171's sampled cases, step by step against the
    reference (tests/test_torch_scheduler.py's differential): a tight
    pool that preempts and resumes by swap and by recompute, the prefix
    cache and the host tier on; every state and event equal after every
    step, and the streams equal to the solo sampled oracle's."""
    pool_kw = dict(batch_size=8, block_size=8, kv_blocks=8,
                   prefill_budget=4, key=KEY, host_blocks=64, **SAMPLE)
    specs = _specs(8, seed=7)
    done, pool, sched, log = _differential(
        specs, pool_kw, dict(overcommit=True, expected_new=2))
    assert pool.stats["preemptions"] > 0
    assert {e[2] for e in log if e[0] == "arm"} == {"swap", "recompute"}
    for i, t, m, _p in specs:
        assert done[i] == _solo_sampled(i, t, m), i


def test_cached_sampled_streams_match():
    """test_prefix_cache.py:427: shared-prefix traffic sampled with the
    prefix cache on equals it cold."""
    rng = np.random.default_rng(19)
    system = rng.integers(1, 32, 24).tolist()
    specs = [(i, system + rng.integers(1, 32, 5).tolist(), 8, 0)
             for i in range(6)]
    kw = dict(paged=True, kv_quant=True, block_size=8, prefill_budget=8,
              key=KEY, device="cpu", **SAMPLE)
    stats: dict = {}
    warm = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 3,
                          stats=stats, **kw)
    cold = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 3,
                          prefix_cache=False, **kw)
    assert warm == cold and stats["prefix_hit_tokens"] > 0


def test_swap_restore_sampled(monkeypatch):
    """test_host_tier.py:143's sampled case: draws key off (rid, stream
    position), so a row whose KV went through host memory keeps its
    stream."""
    monkeypatch.setenv("TPUBC_HOST_XFER_GBPS", "1000")
    monkeypatch.setenv("TPUBC_EXPECTED_NEW", "2")
    specs = _specs(6, seed=13)
    kw = dict(paged=True, kv_quant=True, block_size=8, kv_blocks=8,
              prefill_budget=4, overcommit=True, key=KEY, device="cpu",
              **SAMPLE)
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "64")
    stats: dict = {}
    on = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 6,
                        stats=stats, **kw)
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")
    off = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 6, **kw)
    assert on == off and stats.get("swap_preempts", 0) > 0


def test_crash_recovery_keeps_sampled_streams():
    """A failed round recovered as a preemption of every row: the resumed
    rows draw the same stream (their keys are their rids')."""
    specs = _specs(6, seed=3)
    kw = dict(block_size=8, prefill_budget=4, key=KEY, device="cpu",
              **SAMPLE)
    want = tserving.serve(TPARAMS, TCFG, _reqs(tserving, specs), 4,
                          paged=True, kv_quant=True, **kw)
    pool = tserving.PagedPool(TPARAMS, TCFG, 4, kv_quant=True, **kw)
    sched = tserving.Scheduler(pool)
    faults.install("pool.device:1:3,pool.device:1:9")
    try:
        got = _drive(pool, sched, _reqs(tserving, specs))
    finally:
        faults.install(None)
    assert pool.stats.get("crash_preempts", 0) > 0
    assert got == want


def test_sampled_ingress_reproducible_and_distinct_from_greedy():
    """test_ingress.py:258: two servers with the same pool key, fed the
    same requests in order (the server assigns rids 0, 1, 2), stream the
    same tokens, which are serve()'s for those rids and differ from
    greedy."""
    jobs = [([3, 5, 7], 12), ([9, 2], 8), ([4, 4, 4, 4], 10)]

    def run_server(**kw):
        srv = tingress.IngressServer(TPARAMS, TCFG, port=0, batch_size=2,
                                     kv_quant=True, host="127.0.0.1",
                                     device="cpu", **kw).start()
        try:
            out = []
            for t, m in jobs:  # one after the other: rids 0, 1, 2
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/v1/generate",
                    data=json.dumps({"tokens": t, "max_new": m,
                                     "stream": False}).encode())
                with urllib.request.urlopen(req, timeout=60) as resp:
                    out.append(json.loads(resp.read())["tokens"])
            return out
        finally:
            srv.stop()

    kw = {"temperature": 1.5, "key": KEY}
    a = run_server(**kw)
    assert a == run_server(**kw)
    assert a != run_server()
    want = tserving.serve(TPARAMS, TCFG, [
        tserving.Request(rid=i, tokens=t, max_new=m)
        for i, (t, m) in enumerate(jobs)], 2, kv_quant=True, device="cpu",
        **kw)
    assert a == [want[i] for i in range(3)]
