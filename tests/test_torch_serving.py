"""The slice as a whole: the port's block-paged serving engine
(tpu_bootstrap_torch/workload/serving.py) held to the JAX reference's
serve(paged=True, kv_quant=True, prefix_cache=False, overcommit=False)
on the same bridged int8 weights and requests, and to its own solo
greedy generate (kv_kernel=False: the einsum oracle); the replay-slot
engine (serve(paged=False)) held likewise to the reference's
serve(paged=False), to solo generate, and with a draft model to its own
plain rounds; the allocator and scheduling helpers held to the
reference's by differential tests; and the options the port does not
have yet refusing loudly."""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_decode import assert_greedy_equal
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import serving as jserving
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import faults
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import quant as tquant
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

BASE = dict(vocab_size=64, num_layers=1, num_heads=4, head_dim=16,
            embed_dim=32, mlp_dim=64, max_seq_len=64)
JCFG = jmodel.ModelConfig(**BASE)
TCFG = tmodel.ModelConfig(**BASE)
JPARAMS = jquant.quantize_params(jmodel.init_params(JCFG,
                                                    jax.random.PRNGKey(7)))
TPARAMS = bridge.params_from_numpy(jax.tree.map(np.asarray, JPARAMS),
                                   device="cpu")


def _requests(n, seed, max_prompt=21, max_budget=13):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, BASE["vocab_size"],
                             int(rng.integers(2, max_prompt))).tolist(),
             int(rng.integers(1, max_budget))) for i in range(n)]


def _port_requests(specs):
    return [tserving.Request(rid=i, tokens=t, max_new=m)
            for i, t, m in specs]


def _solo(tokens, max_new, params=None, kv_quant=True):
    return tdecode.generate(TPARAMS if params is None else params, [tokens],
                            TCFG, max_new, kv_quant=kv_quant,
                            kv_kernel=False, device="cpu")[0].tolist()


@pytest.mark.parametrize("pool", [
    dict(batch_size=3, block_size=16, prefill_budget=8),
    # A pool that holds one request at a time: everything queues.
    dict(batch_size=3, kv_blocks=3, block_size=16, prefill_budget=16),
], ids=["default_pool", "tight_pool"])
def test_serve_streams_equal_reference(pool):
    """Same requests, same bridged int8 weights: the port's token streams
    equal the reference's (seed 11 has no near-tie), and each equals the
    port's own solo greedy generate."""
    specs = _requests(6, seed=11)
    want = jserving.serve(
        JPARAMS, JCFG, [jserving.Request(rid=i, tokens=t, max_new=m)
                        for i, t, m in specs],
        paged=True, kv_quant=True, prefix_cache=False, overcommit=False,
        **pool)
    stats: dict = {}
    got = tserving.serve(TPARAMS, TCFG, _port_requests(specs), paged=True,
                         kv_quant=True, prefix_cache=False,
                         overcommit=False, device="cpu", stats=stats, **pool)
    prompts = {i: t for i, t, _ in specs}
    assert set(got) == set(want)
    assert_greedy_equal(got, want, prompts, TPARAMS, TCFG)
    solo = {i: _solo(t, m) for i, t, m in specs}
    assert got == solo
    # Chunked prefill covers every prompt token except the re-fed last
    # one, exactly once.
    assert stats["prefill_tokens"] == sum(len(t) - 1 for _, t, _ in specs)
    assert stats["scheduler"]["admitted"] == len(specs)
    if "kv_blocks" in pool:
        assert stats["blocks_peak"] <= 3


# The slice's other models (2 layers; MoE: 4 experts, top-2): (config,
# reference quantizer).
MODELS = {
    "dense_int4": ({}, lambda p: jquant.quantize_params4(p, group=16)),
    "moe_int8": ({"num_experts": 4}, jquant.quantize_params),
    "moe_int4": ({"num_experts": 4},
                 lambda p: jquant.quantize_params4(p, group=16)),
}
MODEL_POOL = dict(batch_size=2, block_size=16, prefill_budget=8)


@pytest.fixture(scope="module")
def reference_streams():
    """Each model's bridged weights and the reference's serve streams on
    the same 3 short requests, computed once."""
    # Prompts of 9 prefill in one 8-token chunk: few shapes for the
    # reference to compile.
    rng = np.random.default_rng(12)
    specs = [(i, rng.integers(1, BASE["vocab_size"], 9).tolist(), m)
             for i, m in enumerate((6, 4, 5))]
    out = {}
    for name, (kw, quantize) in MODELS.items():
        cfg = {**BASE, "num_layers": 2, **kw}
        jcfg = jmodel.ModelConfig(**cfg)
        jparams = jax.jit(lambda key: quantize(jmodel.init_params(
            jcfg, key)))(jax.random.PRNGKey(13))
        want = jserving.serve(
            jparams, jcfg, [jserving.Request(rid=i, tokens=t, max_new=m)
                            for i, t, m in specs],
            paged=True, kv_quant=True, prefix_cache=False, overcommit=False,
            **MODEL_POOL)
        tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                           device="cpu")
        out[name] = (tmodel.ModelConfig(**cfg), tparams, want)
    return specs, out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_int4_and_moe_serve_streams_equal_reference(reference_streams, name):
    """serve(paged=True, kv_quant=True) on a dense int4 model and on a MoE
    model with int8 and int4 weights: the port's streams equal the
    reference's serve streams. The dense int4 streams may differ at a
    near-tie, judged on the port's solo generate, which they must also
    equal. A MoE stream is held exactly: it is not held to solo generate
    (capacity is contested over each chunk, so a prompt routed in chunks
    keeps other tokens than one routed whole), so a solo margin says
    nothing about where it diverged."""
    specs, models = reference_streams
    tcfg, tparams, want = models[name]
    got = tserving.serve(tparams, tcfg, _port_requests(specs), paged=True,
                         kv_quant=True, device="cpu", **MODEL_POOL)
    prompts = {i: t for i, t, _ in specs}
    assert set(got) == set(want)
    if tcfg.num_experts:
        assert got == {i: list(w) for i, w in want.items()}
    else:
        assert_greedy_equal(got, want, prompts, tparams, tcfg)
    again = tserving.serve(tparams, tcfg, _port_requests(specs), paged=True,
                           kv_quant=True, device="cpu", **MODEL_POOL)
    assert again == got
    if tcfg.num_experts == 0:
        assert got == {i: tdecode.generate(tparams, [t], tcfg, m,
                                           kv_quant=True, kv_kernel=False,
                                           device="cpu")[0].tolist()
                       for i, t, m in specs}


def test_paged_matches_solo_with_eos_and_interleaved_prefill():
    """A long prompt prefills across rounds while a short row streams;
    eos cuts a row inclusively; every stream still equals solo."""
    pool = tserving.PagedPool(TPARAMS, TCFG, 2, block_size=16,
                              prefill_budget=8, kv_quant=True, device="cpu")
    a = tserving.Request(rid=0, tokens=[5, 9, 2], max_new=20)
    b = tserving.Request(rid=1, tokens=list(range(3, 40)), max_new=4)
    pool.admit(a)
    pool.admit(b)
    interleaved, got = 0, {}
    while pool.has_active():
        slot_b = next((s for s in pool.slots if s is not None
                       and s.rid == 1), None)
        b_prefilling = slot_b is not None and pool._prefilling(slot_b)
        events = pool.step_round()
        if b_prefilling and events.get(0, {}).get("new"):
            interleaved += 1
        got.update({rid: ev["generated"] for rid, ev in events.items()
                    if ev["done"]})
    assert interleaved >= 2
    assert got[0] == _solo(a.tokens, a.max_new)
    assert got[1] == _solo(b.tokens, b.max_new)
    eos = got[0][3]
    cut = tserving.serve(TPARAMS, TCFG, [a], 1, paged=True, kv_quant=True,
                         eos_id=eos, device="cpu")
    assert cut[0] == got[0][:got[0].index(eos) + 1]


def test_oom_refusal_and_defrag_keep_streams():
    pool = tserving.PagedPool(TPARAMS, TCFG, 3, kv_blocks=4, block_size=16,
                              kv_quant=True, device="cpu")
    big = tserving.Request(rid=0, tokens=[3] * 16, max_new=30)  # 3 blocks
    small = tserving.Request(rid=1, tokens=[4, 5], max_new=20)  # 2 blocks
    short = tserving.Request(rid=2, tokens=[6, 7], max_new=2)  # 1 block
    pool.admit(short)
    pool.admit(big)
    assert not pool.admits(small)
    with pytest.raises(RuntimeError, match="blocks"):
        pool.admit(small)
    got = {}
    while pool.slots[0] is not None:  # the short row retires first
        got.update({rid: ev["generated"]
                    for rid, ev in pool.step_round().items() if ev["done"]})
    assert pool.allocator.compactness() < 1.0
    assert pool.defrag() > 0 and pool.allocator.compactness() == 1.0
    while pool.has_active():
        got.update({rid: ev["generated"]
                    for rid, ev in pool.step_round().items() if ev["done"]})
    assert got[0] == _solo(big.tokens, big.max_new)
    assert got[2] == _solo(short.tokens, short.max_new)
    assert pool.admits(small)
    tiny = tserving.PagedPool(TPARAMS, TCFG, 1, kv_blocks=2, block_size=16,
                              kv_quant=True, device="cpu")
    with pytest.raises(ValueError, match="never"):
        tiny.validate(tserving.Request(rid=3, tokens=[1] * 8, max_new=40),
                      TCFG)


def test_scheduler_admits_by_priority_then_arrival():
    pool = tserving.PagedPool(TPARAMS, TCFG, 1, block_size=16,
                              kv_quant=True, device="cpu")
    sched = tserving.Scheduler(pool)
    for rid, prio in ((0, 0), (1, 2), (2, 0), (3, 2)):
        sched.submit(tserving.Request(rid=rid, tokens=[rid + 1, 2],
                                      max_new=1, priority=prio))
    order = []
    while sched.pending() or pool.has_active():
        order += [rid for rid, ev in sched.step().items() if ev["done"]]
    assert order == [1, 3, 0, 2]
    assert sched.stats == {"submitted": 4, "admitted": 4, "retired": 4}


def test_block_allocator_differential_against_reference():
    """One random op sequence on both allocators: the same ids, and equal
    available/used/refcount/compactness after every op."""
    rng = np.random.default_rng(3)
    ref = jserving.BlockAllocator(12, 8)
    ref.digest_enabled = False
    port = tserving.BlockAllocator(12, 8)
    owned: list = []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0 and ref.available():
            n = int(rng.integers(1, ref.available() + 1))
            ids = ref.alloc(n)
            assert port.alloc(n) == ids
            owned.append(ids)
        elif op == 1 and owned:
            ids = owned.pop(int(rng.integers(0, len(owned))))
            ref.free(ids)
            port.free(ids)
        elif op == 2 and owned:
            bid = owned[int(rng.integers(0, len(owned)))][0]
            ref.incref(bid)
            port.incref(bid)
            owned.append([bid])
        assert port.available() == ref.available()
        assert port.used() == ref.used()
        assert port.compactness() == ref.compactness()
        for bid in range(13):
            assert port.refcount(bid) == ref.refcount(bid)
    assert port.stats["peak_used"] == ref.stats["peak_used"]
    with pytest.raises(RuntimeError, match="exhausted"):
        port.alloc(port.available() + 1)
    with pytest.raises(ValueError, match="double free"):
        port.free([0])


def test_scheduling_helpers_equal_reference():
    for n in range(1, 300):
        assert tserving._bucket_up(n) == jserving._bucket_up(n)
        assert tserving._bucket_down(n) == jserving._bucket_down(n)
    rng = np.random.default_rng(4)
    for _ in range(300):
        k = int(rng.integers(1, 9))
        active = [tserving._Slot(rid=i, history=[0] * int(rng.integers(1, 60)),
                                 remaining=int(rng.integers(1, 70)),
                                 generated=[]) for i in range(k)]
        cap = int(rng.integers(60, 130))
        assert (tserving._majority_chunk(active, cap)
                == jserving._majority_chunk(active, cap))


@pytest.mark.parametrize("kw,item", [
    ({"prefix_cache": True}, "prefix cache"),
    ({"overcommit": True}, "overcommit"),
    ({"temperature": 0.8}, "sampling"),
    ({"draft_params": TPARAMS}, "spec rounds"),
    ({"spec_lookup": True}, "spec rounds"),
    ({"resident": True}, "item 8"),
    # serve(paged=False) is the slot engine now; with resident=True it is
    # still the unported resident engine.
    pytest.param({"paged": False, "resident": True}, "item 8",
                 id="paged-item 8"),
    ({"kv_quant": False}, "float KV pool"),
], ids=lambda v: v if isinstance(v, str) else "-".join(v))
def test_options_not_ported_raise(kw, item):
    args = {"paged": True, "kv_quant": True, "device": "cpu", **kw}
    reqs = [tserving.Request(rid=0, tokens=[1, 2], max_new=2)]
    with pytest.raises(NotImplementedError, match=item):
        tserving.serve(TPARAMS, TCFG, reqs, 2, **args)


def test_deadlines_and_host_tier_not_ported_raise():
    pool = tserving.PagedPool(TPARAMS, TCFG, 1, kv_quant=True, device="cpu")
    with pytest.raises(NotImplementedError, match="deadlines"):
        tserving.Scheduler(pool).submit(
            tserving.Request(rid=0, tokens=[1], max_new=1, deadline=5.0))
    with pytest.raises(NotImplementedError, match="host tier"):
        tserving.PagedPool(TPARAMS, TCFG, 1, kv_quant=True, host_blocks=4,
                           device="cpu")


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    reqs = [tserving.Request(rid=0, tokens=[1, 2], max_new=2)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserving.serve(TPARAMS, TCFG, reqs, 2, paged=True, kv_quant=True)
    with pytest.raises(ValueError, match="params live on"):
        tserving.PagedPool(TPARAMS, TCFG, 1, kv_quant=True, device="meta")


# ---- the replay-slot engine (serve(paged=False)) ----------------------

SLOT_SPECS = [(i, t, m) for i, (t, m) in enumerate(
    [([3, 14, 15], 5), ([9, 2, 6, 5, 3, 5, 8], 1), ([9, 7], 9),
     ([3, 2, 3, 8, 4], 3), ([6, 2, 6, 4], 6)])]


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8kv", "fkv"])
def test_slot_serve_matches_reference_and_solo(kv_quant):
    """serve(paged=False) through a 2-slot pool (rows admitted at different
    rounds, ragged histories replayed left-padded): the port's streams
    equal the reference's serve(paged=False) on the same bridged int8
    weights, and each equals the port's solo generate(kv_kernel=False).
    The schedule's accounting equals the reference's."""
    want_stats, stats = {}, {}
    want = jserving.serve(
        JPARAMS, JCFG, [jserving.Request(rid=i, tokens=t, max_new=m)
                        for i, t, m in SLOT_SPECS],
        batch_size=2, kv_quant=kv_quant, stats=want_stats)
    got = tserving.serve(TPARAMS, TCFG, _port_requests(SLOT_SPECS), 2,
                         kv_quant=kv_quant, stats=stats, device="cpu")
    assert set(got) == set(want)
    assert_greedy_equal(got, want, {i: t for i, t, _ in SLOT_SPECS},
                        TPARAMS, TCFG)
    assert got == {i: _solo(t, m, kv_quant=kv_quant)
                   for i, t, m in SLOT_SPECS}
    for key in ("rounds", "slot_steps", "active_slot_steps",
                "replayed_tokens"):
        assert stats[key] == want_stats[key], key
    assert stats["active_slot_steps"] <= stats["slot_steps"]


def test_slot_eos_finishes_rows_early():
    """eos_id retires a slot row at its first emission, inclusive."""
    prompt = [5, 1, 4, 9]
    full = _solo(prompt, 12)
    eos = full[2]
    got = tserving.serve(TPARAMS, TCFG,
                         [tserving.Request(rid=0, tokens=prompt,
                                           max_new=12)],
                         1, kv_quant=True, eos_id=eos, device="cpu")
    assert got[0] == full[:full.index(eos) + 1]


def test_slot_replayed_tokens_accounting():
    """Every round re-prefills each active row's history: round 1 chunk 2
    (the smallest budget) over histories 3 and 2; round 2 rid 0 alone,
    history 5, chunk 2: 10 tokens replayed in 2 rounds."""
    reqs = [tserving.Request(rid=0, tokens=[1, 2, 3], max_new=4),
            tserving.Request(rid=1, tokens=[4, 5], max_new=2)]
    stats: dict = {}
    tserving.serve(TPARAMS, TCFG, reqs, 2, kv_quant=True, stats=stats,
                   device="cpu")
    assert stats["replayed_tokens"] == 10 and stats["rounds"] == 2


@pytest.fixture(scope="module")
def float_target():
    """A float target (the reference's init, bridged) and its int8 copy,
    the self-speculation draft."""
    params = bridge.params_from_numpy(jax.tree.map(
        np.asarray, jmodel.init_params(JCFG, jax.random.PRNGKey(7))),
        device="cpu")
    return params, tquant.quantize_params(params)


def test_slot_speculative_serve_bit_matches_plain_and_solo(float_target):
    """Speculative rounds commit the target's own argmaxes: the streams
    equal the plain rounds' and solo generate's, and the schedule (rounds,
    slot steps) is the same."""
    params, draft = float_target
    specs = _requests(8, seed=3)
    plain_stats, spec_stats = {}, {}
    plain = tserving.serve(params, TCFG, _port_requests(specs), 4,
                           stats=plain_stats, device="cpu")
    spec = tserving.serve(params, TCFG, _port_requests(specs), 4,
                          stats=spec_stats, draft_params=draft,
                          draft_cfg=TCFG, gamma=3, device="cpu")
    assert plain == spec
    assert plain == {i: _solo(t, m, params=params, kv_quant=False)
                     for i, t, m in specs}
    for key in ("rounds", "slot_steps", "active_slot_steps"):
        assert spec_stats[key] == plain_stats[key], key


def test_slot_speculative_serve_commits_more_than_one_token_per_stream(
        float_target):
    """The lever: committed tokens per target weight stream (verify
    round) above 1, and gamma + 1 draft steps per verify round."""
    params, draft = float_target
    stats: dict = {}
    tserving.serve(params, TCFG, _port_requests(_requests(8, seed=3)), 4,
                   stats=stats, draft_params=draft, draft_cfg=TCFG, gamma=3,
                   device="cpu")
    assert stats["verify_rounds"] > 0
    assert stats["committed_tokens"] / stats["verify_rounds"] > 1.0, stats
    assert stats["draft_steps"] == stats["verify_rounds"] * 4


def test_slot_pool_refusals_and_fault_seam():
    """What the slot engine refuses (sampling, a draft without its config,
    gamma < 1, prompt lookup), and the pool.device seam failing a round
    before it dispatches."""
    reqs = [tserving.Request(rid=0, tokens=[1, 2], max_new=2)]
    with pytest.raises(NotImplementedError, match="item 5"):
        tserving.serve(TPARAMS, TCFG, reqs, 2, temperature=0.5,
                       device="cpu")
    with pytest.raises(ValueError, match="draft_cfg"):
        tserving.SlotPool(TPARAMS, TCFG, 2, draft_params=TPARAMS,
                          device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        tserving.SlotPool(TPARAMS, TCFG, 2, draft_params=TPARAMS,
                          draft_cfg=TCFG, gamma=0, device="cpu")
    with pytest.raises(ValueError, match="spec_lookup"):
        tserving.serve(TPARAMS, TCFG, reqs, 2, spec_lookup=True,
                       device="cpu")
    pool = tserving.SlotPool(TPARAMS, TCFG, 2, kv_quant=True, device="cpu")
    pool.admit(tserving.Request(rid=0, tokens=[1, 2], max_new=3))
    assert pool.admits(reqs[0])
    faults.install("pool.device:1:1")
    try:
        assert pool.step_round()[0]["new"]  # call 1 passes
        with pytest.raises(faults.InjectedFault):
            pool.step_round()  # call 2 fires
    finally:
        faults.install(None)
    pool.reset()
    assert not pool.has_active()
