"""The paged engine's prefix cache (tpu_bootstrap_torch/workload/serving.py:
block_hash and the digest helpers, BlockAllocator's content index,
PagedPool's cache-aware admission with copy-on-write) held to the JAX
reference: the hashes byte for byte; the allocators by differential tests
that run both through the same seeded op sequences and compare their whole
state after every op; the pools' stats exactly and their greedy streams on
the same bridged int8 weights and shared-prefix traffic; and the mirrors of
the reference's own tests/test_prefix_cache.py on the port's pool
(device="cpu", K2's plain version).

Not mirrored here: the ingress half (test_prefix_cache.py:370, in
tests/test_torch_ingress_paged.py), sampled streams (:427, item 5.7), the speculative pools (:443, item 5.8)
and sharded params (:466, item 11); the resident halves of :352 and :411
wait for the resident engine (item 8). Streams across the two frameworks
may part only at a near-tie (tests/test_torch_decode.py:NEAR_TIE, judged by
the port's solo logits); within the port, cached streams equal cold ones and
solo generate exactly (every kernel's plain version is batch- and
table-invariant on the CPU)."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_decode import assert_greedy_equal
from tpu_bootstrap.workload import decode_attention as jda
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import decode_attention as tda
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

# The reference's TINY model (test_prefix_cache.py:29) at the port's
# smallest head dim (K2 takes multiples of 16), int8 weights.
BASE = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=16,
            embed_dim=16, mlp_dim=32, max_seq_len=64)
JCFG = jmodel.ModelConfig(**BASE)
TCFG = tmodel.ModelConfig(**BASE)
JPARAMS = jquant.quantize_params(jmodel.init_params(JCFG,
                                                    jax.random.PRNGKey(1)))
TPARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                   device="cpu")
POOL = dict(kv_quant=True, device="cpu")


@pytest.fixture(autouse=True)
def _reference_without_host_tier(monkeypatch):
    """The host tier (queue 1 item 5.2) is off in both packages here, so
    evictions discard and the pools are held to each other on the prefix
    cache alone; tests/test_torch_host_tier.py holds the tier."""
    monkeypatch.setenv("TPUBC_KV_HOST_BLOCKS", "0")


def _solo(tokens, max_new):
    return tdecode.generate(TPARAMS, [tokens], TCFG, max_new, kv_quant=True,
                            kv_kernel=False, device="cpu")[0].tolist()


def _drain(pool):
    got = {}
    while pool.has_active():
        for rid, ev in pool.step_round().items():
            if ev["done"]:
                got[rid] = ev["generated"]
    return got


def _shared_prefix_specs(n, sys_len=24, tail=4, max_new=6, seed=0,
                         vocab=32):
    """One shared system prompt and a short unique tail per request, as
    (rid, tokens, max_new): the reference's test traffic and, at block 8
    with sys_len 24, bench.py:867-889's shape (three full blocks shared)
    cut to a small width."""
    rng = np.random.default_rng(seed)
    sysp = rng.integers(1, vocab, sys_len).tolist()
    return [(i, sysp + rng.integers(1, vocab, tail).tolist(), max_new)
            for i in range(n)]


def _port_reqs(specs):
    return [tserving.Request(rid=i, tokens=t, max_new=m) for i, t, m in specs]


def _ref_reqs(specs):
    return [jserving.Request(rid=i, tokens=t, max_new=m) for i, t, m in specs]


# ---- hashes ------------------------------------------------------------


def test_block_hash_chains_on_parent():
    """test_prefix_cache.py:67: a block's key commits to its whole
    prefix, is deterministic and content-sensitive."""
    toks = [3, 1, 4, 1, 5, 9, 2, 6]
    root = tserving.block_hash(b"", toks)
    assert tserving.block_hash(root, toks) != root
    assert tserving.block_hash(tserving.block_hash(b"", [7] * 8),
                               toks) != root
    assert tserving.block_hash(b"", list(toks)) == root
    assert tserving.block_hash(b"", toks[:-1] + [7]) != root


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hashes_and_digest_match_equal_reference(seed):
    """block_hash and key_fingerprint byte for byte on random chains, and
    digest_match_len on digests with and without the host sub-dict,
    holes, other block sizes and malformed input."""
    rng = np.random.default_rng(seed)
    key_t, key_j = b"", b""
    keys = []
    for _ in range(12):
        toks = rng.integers(0, 2 ** 31, int(rng.integers(1, 9))).tolist()
        key_t = tserving.block_hash(key_t, toks)
        key_j = jserving.block_hash(key_j, toks)
        assert key_t == key_j
        assert tserving.key_fingerprint(key_t) == jserving.key_fingerprint(
            key_j)
        keys.append(key_t)
    tokens = rng.integers(1, 50, 40).tolist()
    chain, key = [], b""
    for j in range(len(tokens) // 8):
        key = tserving.block_hash(key, tokens[j * 8:(j + 1) * 8])
        chain.append(tserving.key_fingerprint(key))
    digests = [
        {"block_size": 8, "fps": chain[:3]},
        {"block_size": 8, "fps": chain[:1], "host": {"fps": chain[1:4]}},
        {"block_size": 8, "fps": chain[:1] + chain[2:]},  # a hole
        {"block_size": 8, "fps": []},
        {"block_size": 8, "fps": [], "host": {"fps": chain}},
        {"block_size": 4, "fps": chain},
        {"block_size": 0, "fps": chain},
        {"fps": chain},
        {"block_size": 8, "fps": chain, "host": "not a dict"},
        None,
        [1, 2],
    ]
    for d in digests:
        assert (tserving.digest_match_len(tokens, d)
                == jserving.digest_match_len(tokens, d)), d


# ---- allocator: differential against the reference ----------------------


def _alloc_state(a) -> tuple:
    return (sorted(a._free), dict(a._ref), list(a._cached.items()),
            dict(a._index), dict(a._key_of), a.digest_json(), dict(a.stats),
            a.available(), a.used(), a.cached(), a.compactness())


def _both(ref, port, op, *args):
    """Run ``op`` on both allocators: the same result, or the same
    exception type."""
    outs = []
    for a in (ref, port):
        try:
            outs.append(("ok", getattr(a, op)(*args)))
        except (ValueError, RuntimeError, KeyError) as e:
            outs.append(("raise", type(e).__name__))
    assert outs[0] == outs[1], (op, args, outs)
    return outs[0]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_differential_against_reference(seed):
    """Seeded random sequences of alloc / incref / free / register /
    lookup / evict / remap, and the refusals (exhaustion, double free,
    incref of a free block, register of a dead one), on the port's and
    the reference's BlockAllocator: after every op the same result and
    the same whole state (free heap, refcounts, cached LRU order, index,
    key_of, digest and stats)."""
    rng = np.random.default_rng(seed)
    n = 16
    ref, port = jserving.BlockAllocator(n, 8), tserving.BlockAllocator(n, 8)
    rows: list = []  # each a list of block ids one row table references

    def key():  # a small key space, so duplicates happen
        return tserving.block_hash(b"", [int(rng.integers(0, 12))] * 8)

    for _ in range(300):
        op = int(rng.integers(0, 9))
        live = sorted({b for r in rows for b in r})
        if op == 0:
            k = int(rng.integers(1, 5))
            status, ids = _both(ref, port, "alloc", k)
            if status == "ok":
                rows.append(list(ids))
        elif op == 1 and rows:
            _both(ref, port, "free", rows.pop(int(rng.integers(len(rows)))))
        elif op == 2 and (live or ref._cached):
            pick = live + list(ref._cached)
            bid = pick[int(rng.integers(len(pick)))]
            _both(ref, port, "incref", bid)
            rows.append([bid])
        elif op == 3 and live:
            _both(ref, port, "register", live[int(rng.integers(len(live)))],
                  key())
        elif op == 4:
            _both(ref, port, "lookup", key())
        elif op == 5 and ref._cached:
            _both(ref, port, "evict_one")
        elif op == 6:
            taken = sorted(set(live) | set(ref._cached))
            perm = rng.permutation(np.arange(1, n + 1))[:len(taken)]
            mapping = {b: int(m) for b, m in zip(taken, perm)}
            _both(ref, port, "remap", mapping)
            rows = [[mapping[b] for b in r] for r in rows]
        elif op == 7:  # refusals
            free = [b for b in range(1, n + 1)
                    if b not in live and b not in ref._cached]
            if free:
                bid = free[int(rng.integers(len(free)))]
                _both(ref, port, "free", [bid])
                _both(ref, port, "incref", bid)
                _both(ref, port, "register", bid, key())
            _both(ref, port, "alloc", ref.available() + 1)
            _both(ref, port, "alloc", 0)
        elif op == 8 and ref.available():
            _both(ref, port, "digest_json")
        assert _alloc_state(port) == _alloc_state(ref)


def test_allocator_digest_off_equals_reference(monkeypatch):
    """TPUBC_CACHE_DIGEST=0: both digests report empty while the index
    works."""
    monkeypatch.setenv("TPUBC_CACHE_DIGEST", "0")
    ref, port = jserving.BlockAllocator(4, 8), tserving.BlockAllocator(4, 8)
    for a in (ref, port):
        (b,) = a.alloc(1)
        assert a.register(b, tserving.block_hash(b"", [1] * 8))
    assert port.digest_json() == ref.digest_json()
    assert port.digest_json()["fps"] == [] and port.lookup(
        tserving.block_hash(b"", [1] * 8)) == 1


# ---- allocator: mirrors of the reference's tests ------------------------


def test_refcount_sharing_no_premature_reuse():
    """test_prefix_cache.py:84."""
    a = tserving.BlockAllocator(4, block_size=8)
    (b1,) = a.alloc(1)
    a.register(b1, tserving.block_hash(b"", [1] * 8))
    a.incref(b1)
    assert a.refcount(b1) == 2
    a.free([b1])
    assert a.refcount(b1) == 1 and not a.is_cached(b1)
    got = a.alloc(3)
    assert b1 not in got
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc(1)
    a.free([b1])
    assert a.is_cached(b1) and a.used() == 3 and a.cached() == 1
    assert a.alloc(1) == [b1]
    assert a.lookup(tserving.block_hash(b"", [1] * 8)) is None


def test_refcount_invariants_random_churn():
    """test_prefix_cache.py:108: the three block states stay disjoint
    and exhaustive under random share/retire churn."""
    rng = np.random.default_rng(0)
    a = tserving.BlockAllocator(24, block_size=8)
    rows = []
    next_key = [0]

    def new_key():
        next_key[0] += 1
        return tserving.block_hash(b"", [next_key[0]] * 8)

    for _ in range(400):
        p = rng.random()
        if rows and (p < 0.35 or a.available() < 4):
            a.free(rows.pop(int(rng.integers(len(rows)))))
        elif rows and p < 0.55:
            src = rows[int(rng.integers(len(rows)))]
            for b in src:
                a.incref(b)
            rows.append(list(src))
        else:
            k = int(rng.integers(1, 4))
            if k <= a.available():
                ids = a.alloc(k)
                for b in ids:
                    if rng.random() < 0.5:
                        a.register(b, new_key())
                rows.append(ids)
        live = {b for r in rows for b in r}
        assert a.used() == len(live)
        refs: dict = {}
        for r in rows:
            for b in r:
                refs[b] = refs.get(b, 0) + 1
        assert all(a.refcount(b) == c for b, c in refs.items())
        free_set, cached_set = set(a._free), set(a._cached)
        assert not (live & free_set)
        assert not (live & cached_set)
        assert not (free_set & cached_set)
        assert len(live) + len(free_set) + len(cached_set) == 24


def test_lru_eviction_order():
    """test_prefix_cache.py:155."""
    a = tserving.BlockAllocator(3, block_size=8)
    keys = [tserving.block_hash(b"", [i] * 8) for i in range(3)]
    ids = a.alloc(3)
    for b, k in zip(ids, keys):
        a.register(b, k)
    a.free([ids[1]])
    a.free([ids[0]])
    a.free([ids[2]])
    assert a.cached() == 3 and a.available() == 3
    got = a.alloc(2)
    assert sorted(got) == sorted([ids[1], ids[0]])
    assert a.lookup(keys[1]) is None and a.lookup(keys[0]) is None
    assert a.lookup(keys[2]) == ids[2]
    a.incref(ids[2])
    a.free([ids[2]])
    assert a.is_cached(ids[2])


# ---- the pool: mirrors ----------------------------------------------------


def test_admission_with_hits_capacity_math():
    """test_prefix_cache.py:181: a warm prompt reserves only its uncovered
    footprint, so a pool too small for two cold copies holds two warm."""
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 32, 17)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 3, kv_blocks=5, block_size=8,
                              **POOL)
    pool.admit(tserving.Request(rid=0, tokens=prompt, max_new=7))
    assert not pool.admits(tserving.Request(rid=1, tokens=prompt, max_new=7))
    got = _drain(pool)
    warm = tserving.Request(rid=1, tokens=prompt, max_new=7)
    assert pool.admits(warm)
    pool.admit(warm)
    s = [x for x in pool.slots if x is not None][0]
    assert s.n_shared == 2 and s.cached_tokens == 16
    assert pool.stats["prefix_hit_tokens"] == 16
    assert pool.request_cached_tokens == {0: 0, 1: 16}
    assert pool.allocator.used() == 3
    got.update(_drain(pool))
    assert got[0] == got[1] == _solo(prompt, 7)


def test_shared_system_prompt_beats_no_cache_at_equal_memory():
    """test_prefix_cache.py:206: at equal KV memory the caching pool
    admits more requests with fewer live blocks each, and the hit rate on
    the bench traffic shape clears 0.5."""
    specs = _shared_prefix_specs(24, sys_len=24, tail=4, max_new=6, seed=7)
    reqs = _port_reqs(specs)
    kw = dict(kv_blocks=24, block_size=8, **POOL)
    cold_pool = tserving.PagedPool(TPARAMS, TCFG, 24, **kw,
                                   prefix_cache=False)
    warm_pool = tserving.PagedPool(TPARAMS, TCFG, 24, **kw)
    warm_pool.admit(reqs[0])
    _drain(warm_pool)
    n_cold = n_warm = 0
    for r in reqs[1:]:
        if cold_pool.admits(r):
            cold_pool.admit(r)
            n_cold += 1
    for r in reqs[1:]:
        if warm_pool.admits(r):
            warm_pool.admit(r)
            n_warm += 1
    assert n_warm > n_cold, (n_warm, n_cold)
    assert (warm_pool.allocator.used() / n_warm
            < cold_pool.allocator.used() / n_cold)
    stats = warm_pool.stats
    assert stats["prefix_hit_tokens"] / stats["prompt_tokens"] > 0.5


def test_cached_blocks_never_block_admission():
    """test_prefix_cache.py:238: an empty heap whose cached set covers
    the request admits it (eviction is part of alloc); streams exact."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, kv_blocks=4, block_size=8,
                              **POOL)
    rng = np.random.default_rng(5)
    for i in range(6):
        toks = [int(t) for t in rng.integers(1, 32, 10)]
        r = tserving.Request(rid=i, tokens=toks, max_new=8)
        assert pool.admits(r), (i, pool.allocator.available())
        pool.admit(r)
        assert _drain(pool)[i] == _solo(toks, 8), i
    assert pool.allocator.stats["evictions"] > 0


def test_cow_on_partial_block_extension():
    """test_prefix_cache.py:256: a block-aligned prompt matching the
    cached chain into the block it must write takes a private copy: no
    prefill at all, the source untouched and still indexed, output
    exact; the copy holds the source's bytes in every pool tensor."""
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 32, 16)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8, **POOL)
    pool.admit(tserving.Request(rid=0, tokens=prompt, max_new=9))
    got = _drain(pool)
    key1 = tserving.block_hash(tserving.block_hash(b"", prompt[:8]),
                               prompt[8:16])
    src = pool.allocator.lookup(key1)
    assert src is not None
    before = [{n: a[src].clone() for n, a in layer.items()}
              for layer in pool.pools]
    pool.admit(tserving.Request(rid=1, tokens=prompt, max_new=9))
    s = [x for x in pool.slots if x is not None][0]
    assert pool.stats["cow_copies"] == 1
    assert s.n_shared == 1 and s.blocks[0] == pool.allocator.lookup(
        tserving.block_hash(b"", prompt[:8]))
    assert s.blocks[1] != src
    for layer, was in zip(pool.pools, before):
        for n, a in layer.items():
            assert torch.equal(a[s.blocks[1]], was[n]), n
    assert s.prefilled == 15 and s.cached_tokens == 15
    got.update(_drain(pool))
    assert got[0] == got[1] == _solo(prompt, 9)
    assert pool.allocator.lookup(key1) == src
    for layer, was in zip(pool.pools, before):
        for n, a in layer.items():
            assert torch.equal(a[src], was[n]), n


def test_cache_hits_survive_mid_flight_defrag():
    """test_prefix_cache.py:286."""
    prompt = [int(t) for t in np.random.default_rng(9).integers(1, 32, 16)]
    pool = tserving.PagedPool(TPARAMS, TCFG, 3, block_size=8, **POOL)
    pool.admit(tserving.Request(rid=50, tokens=[2, 3, 4], max_new=20))
    pool.admit(tserving.Request(rid=0, tokens=prompt, max_new=9))
    got = _drain(pool)
    assert got[0] == _solo(prompt, 9)
    cached_before = pool.allocator.cached()
    assert cached_before >= 2
    moved = pool.defrag()
    assert moved > 0 and pool.allocator.compactness() == 1.0
    assert pool.allocator.cached() == cached_before
    pool.admit(tserving.Request(rid=1, tokens=prompt, max_new=9))
    s = [x for x in pool.slots if x is not None][0]
    assert s.cached_tokens > 0, "hit lost across defrag"
    assert _drain(pool)[1] == got[0]


def test_paged_kernel_parity_with_aliased_tables():
    """test_prefix_cache.py:313 at the port's head dim (16): K2's plain
    version over tables that alias blocks across rows equals the gather
    oracle (rtol 2e-5, atol 2e-6, the reference's limits) and the
    reference's paged kernel (interpret mode) on the same inputs (the
    same limits: both are f32 softmaxes over the same dequantized
    values, summed in other orders)."""
    b, h, hk, d, bs, nblk, nb = 3, 8, 2, 16, 8, 12, 3
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.standard_normal((b, h, d), np.float32))
    k = torch.as_tensor(rng.standard_normal((nblk, bs, hk, d), np.float32))
    v = torch.as_tensor(rng.standard_normal((nblk, bs, hk, d), np.float32))
    kq, kscale = tdecode._quantize_kv(k)
    vq, vscale = tdecode._quantize_kv(v)
    bt = torch.tensor([[3, 7, 1], [3, 7, 5], [3, 9, 0]], dtype=torch.int32)
    lengths = torch.tensor([20, 18, 11], dtype=torch.int32)
    got = tda.paged_decode_attention_int8(q, kq, kscale, vq, vscale, bt,
                                          lengths)
    kd = (kq.float() * kscale[..., None])[bt.long()].reshape(b, nb * bs, hk,
                                                             d)
    vd = (vq.float() * vscale[..., None])[bt.long()].reshape(b, nb * bs, hk,
                                                             d)
    qg = q.reshape(b, hk, h // hk, d)
    s = torch.einsum("bkgd,blkd->bkgl", qg, kd) * d ** -0.5
    mask = (torch.arange(nb * bs)[None, :] < lengths[:, None])[:, None, None]
    s = torch.where(mask, s, torch.tensor(-1e30))
    want = torch.einsum("bkgl,blkd->bkgd", torch.softmax(s, -1),
                        vd).reshape(b, h, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-6)
    ref = jda.paged_decode_attention_int8(
        *(np.asarray(t) for t in (q, kq, kscale, vq, vscale, bt, lengths)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-6)


def test_cached_equals_cold_and_solo_greedy():
    """test_prefix_cache.py:352 (its cached == cold == solo half):
    shared-prefix traffic with caching on gives byte-identical streams to
    the cold pool and to solo generate, while hitting the cache."""
    specs = _shared_prefix_specs(6, sys_len=24, tail=4, max_new=6, seed=11)
    stats: dict = {}
    kw = dict(paged=True, block_size=8, prefill_budget=8, **POOL)
    warm = tserving.serve(TPARAMS, TCFG, _port_reqs(specs), 3, stats=stats,
                          **kw)
    cold = tserving.serve(TPARAMS, TCFG, _port_reqs(specs), 3,
                          prefix_cache=False, **kw)
    assert warm == cold
    for i, t, m in specs:
        assert warm[i] == _solo(t, m), i
    assert stats["prefix_hit_tokens"] > 0
    assert stats["prefix_hit_requests"] >= 3


def test_cached_matrix_greedy_int8kv():
    """test_prefix_cache.py:411 (kv_quant=True, its cached == cold half)
    on the reference's wider vocabulary, batch 4."""
    cfg = tmodel.ModelConfig(**{**BASE, "vocab_size": 64})
    jcfg = jmodel.ModelConfig(**{**BASE, "vocab_size": 64})
    params = bridge.params_from_numpy(jax.tree.map(
        np.asarray, jquant.quantize_params(jmodel.init_params(
            jcfg, jax.random.PRNGKey(0)))), device="cpu")
    specs = _shared_prefix_specs(10, sys_len=24, tail=5, max_new=8, seed=17,
                                 vocab=64)
    kw = dict(paged=True, block_size=8, prefill_budget=8, **POOL)
    warm = tserving.serve(params, cfg, _port_reqs(specs), 4, **kw)
    cold = tserving.serve(params, cfg, _port_reqs(specs), 4,
                          prefix_cache=False, **kw)
    assert warm == cold


# ---- the pool: against the reference's ------------------------------------

# (system prompt, tail, max_new, requests, batch): bench.py:867-889's shape
# at block 8 (three full blocks shared, a short unique tail), and
# block-aligned prompts that end inside a cached block (copy-on-write).
TRAFFIC = {"bench_shape": (24, 2, 4, 12, 4), "aligned_cow": (16, 0, 3, 6, 2)}
STAT_KEYS = ("rounds", "slot_steps", "active_slot_steps", "prefill_tokens",
             "prefill_chunks", "blocks_peak", "blocks_total", "prompt_tokens",
             "prefix_hit_tokens", "prefix_hit_requests", "cow_copies")


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_cached_pool_equals_reference(name):
    """The port's and the reference's caching PagedPool on the same
    traffic and bridged weights: the schedule and cache stats exactly
    equal, the streams equal (near-ties allowed across frameworks), the
    port's cached streams equal its cold ones and solo generate."""
    sys_len, tail, max_new, n, batch = TRAFFIC[name]
    specs = _shared_prefix_specs(n, sys_len=sys_len, tail=tail,
                                 max_new=max_new, seed=13)
    kw = dict(paged=True, kv_quant=True, block_size=8, prefill_budget=8,
              overcommit=False)
    want_stats, stats = {}, {}
    want = jserving.serve(JPARAMS, JCFG, _ref_reqs(specs), batch,
                          prefix_cache=True, stats=want_stats, **kw)
    got = tserving.serve(TPARAMS, TCFG, _port_reqs(specs), batch,
                         stats=stats, device="cpu", **kw)
    for key in STAT_KEYS:
        assert stats[key] == want_stats[key], key
    assert stats["prefix_hit_tokens"] > 0
    if name == "aligned_cow":
        assert stats["cow_copies"] > 0
    assert set(got) == set(want)
    assert_greedy_equal(got, want, {i: t for i, t, _ in specs}, TPARAMS,
                        TCFG)
    cold = tserving.serve(TPARAMS, TCFG, _port_reqs(specs), batch,
                          prefix_cache=False, device="cpu", **kw)
    assert got == cold == {i: _solo(t, m) for i, t, m in specs}


def test_allocator_and_digest_after_traffic_equal_reference():
    """After the same shared-prefix traffic driven round by round, the
    two pools' allocators hold the same state and publish the same cache
    digest, and a request's hits are the same."""
    specs = _shared_prefix_specs(5, sys_len=24, tail=3, max_new=3, seed=21)
    ref = jserving.PagedPool(JPARAMS, JCFG, 2, block_size=8,
                             prefill_budget=8, kv_quant=True,
                             prefix_cache=True, host_blocks=0)
    port = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=8,
                              prefill_budget=8, **POOL)
    pending = list(specs)
    while pending or port.has_active():
        while pending and port.admits(_port_reqs(pending[:1])[0]):
            assert ref.admits(_ref_reqs(pending[:1])[0])
            ref.admit(_ref_reqs(pending[:1])[0])
            port.admit(_port_reqs(pending[:1])[0])
            pending.pop(0)
        ref.step_round()
        port.step_round()
        assert _alloc_state(port.allocator) == _alloc_state(ref.allocator)
    assert not ref.has_active()
    assert port._cache_digest_json() == ref._cache_digest_json()
    assert port.request_cached_tokens == ref.request_cached_tokens


def test_prefix_cache_gauges():
    """The reference's names: kv_blocks_cached, serve_prefix_hit_rate and
    kv_prefix_hit_tokens_total after a cached serve."""
    telemetry.metrics().reset()
    specs = _shared_prefix_specs(4, sys_len=24, tail=2, max_new=2, seed=3)
    stats: dict = {}
    tserving.serve(TPARAMS, TCFG, _port_reqs(specs), 1, paged=True,
                   block_size=8, stats=stats, **POOL)
    m = telemetry.metrics().to_json()
    assert m["kv_prefix_hit_tokens_total"] == stats["prefix_hit_tokens"] > 0
    assert m["serve_prefix_hit_rate"] == round(
        stats["prefix_hit_tokens"] / stats["prompt_tokens"], 4)
    # Every row retired: the system prompt's three blocks stay cached.
    assert m["kv_blocks_cached"] == 3 and m["kv_blocks_used"] == 0
