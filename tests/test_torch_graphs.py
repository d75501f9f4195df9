"""The decode loops as CUDA graphs (tpu_bootstrap_torch/workload/graphs.py,
PagedPool's captured chunk step, generate's captured step), rehearsed on the
CPU: the static-buffer step bodies, run as the graphs run them (a warm-up
step, then replays) through a stand-in for the CUDA side, equal the eager
loops bitwise in tokens and every pool or cache byte; decode_step with a
0-d tensor position equals its int form bitwise; the launch counts stay
honest under a stand-in capture that, like CUDA's, runs the wrappers'
Python without executing and replays without Python; and a capture or
replay that fails raises and never continues eagerly. That the captured
graphs equal the eager loops on the card is chip_smoke.py's serve,
serve_int4, serve_moe and generate_int8kv phases. Tolerance: none, every
comparison is bitwise (the same plain-version ops in the same order)."""

import jax
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import decode as tdecode
from tpu_bootstrap_torch.workload import graphs, kernels
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import serving as tserving

torch.set_num_threads(2)

BASE = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=16,
            embed_dim=32, mlp_dim=64, max_seq_len=64)
TCFG = tmodel.ModelConfig(**BASE)
_JCFG = jmodel.ModelConfig(**BASE)
FLOAT = bridge.params_from_numpy(jax.tree.map(
    np.asarray, jmodel.init_params(_JCFG, jax.random.PRNGKey(5))),
    device="cpu")
INT8 = bridge.params_from_numpy(jax.tree.map(
    np.asarray, jquant.quantize_params(jmodel.init_params(
        _JCFG, jax.random.PRNGKey(5)))), device="cpu")
MOE_CFG = tmodel.ModelConfig(**BASE, num_experts=4)
MOE4 = bridge.params_from_numpy(jax.tree.map(
    np.asarray, jquant.quantize_params4(jmodel.init_params(
        jmodel.ModelConfig(**BASE, num_experts=4), jax.random.PRNGKey(6)),
        group=16)), device="cpu")


class Replaying:
    """A CPU stand-in for the CUDA side: the warm-up runs the step, a
    capture records it without running it (a CUDA capture executes no
    kernel), a replay runs it."""

    def __init__(self):
        self.captures = 0

    def warm_up(self, body):
        body()

    def capture(self, body):
        self.captures += 1
        return body

    def replay(self, graph):
        graph()


class Counting(Replaying):
    """Emulates how CUDA splits the work of a step: a capture runs the
    body's Python (the wrappers count their launches) but executes
    nothing, and a replay executes with no Python (no count moves)."""

    def __init__(self):
        super().__init__()
        self.capturing = False

    def capture(self, body):
        self.capturing = True
        try:
            body()
        finally:
            self.capturing = False
        return super().capture(body)

    def replay(self, graph):
        saved = dict(kernels.LAUNCHES)
        graph()
        kernels.LAUNCHES.update(saved)


class Failing(Replaying):
    def __init__(self, at: str):
        super().__init__()
        self.at = at

    def capture(self, body):
        if self.at == "capture":
            raise RuntimeError("stand-in capture failed")
        return super().capture(body)

    def replay(self, graph):
        if self.at == "replay":
            raise RuntimeError("stand-in replay failed")
        graph()


@pytest.fixture
def stand_in(monkeypatch):
    """Every new owner gets StepGraphs over the returned list's backend
    (set its first element), as a CUDA owner would get them."""
    holder = [Replaying()]
    monkeypatch.setattr(graphs, "for_device",
                        lambda device: graphs.StepGraphs(holder[0]))
    return holder


@pytest.fixture
def launches():
    saved = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    yield kernels.LAUNCHES
    kernels.LAUNCHES.update(saved)


def _clone(pools):
    return [{n: a.clone() for n, a in layer.items()} for layer in pools]


def _assert_pools_equal(got, want):
    for gl, wl in zip(got, want):
        for n in gl:
            assert torch.equal(gl[n], wl[n]), n


# ---- the paged engine ----------------------------------------------------


def _mid_serve_pool(params, cfg, specs, batch, rounds):
    """A pool ``rounds`` rounds into ``specs`` (rid, prompt, max_new, the
    round it is admitted at), then through the next round's prefill phase:
    the state a decode chunk starts from."""
    pool = tserving.PagedPool(params, cfg, batch, block_size=16,
                              prefill_budget=16, kv_quant=True, device="cpu")
    for r in range(rounds + 1):
        for i, t, m, at in specs:
            if at == r:
                pool.admit(tserving.Request(rid=i, tokens=t, max_new=m))
        if r < rounds:
            pool.step_round()
    pool.stats["rounds"] += 1
    pool._prefill_phase()
    return pool


# (params, cfg, requests, batch, rounds before the chunk): batch 4 with 2-3
# rows keeps dummy rows in every chunk; budgets under the chunk overshoot;
# a 32-token prompt registered by rid 0 is hit by rid 1, admitted once rid
# 0 has prefilled it: the two rows' tables alias the same blocks.
SHARED = list(range(1, 33))
CASES = {
    "dummy_rows_overshoot": (INT8, TCFG, [(0, [5, 9, 2], 3, 0),
                                          (1, list(range(3, 20)), 9, 0)],
                             4, 1),
    "aliased_table": (INT8, TCFG, [(0, SHARED + [7], 30, 0),
                                   (1, SHARED + [9, 4], 10, 3),
                                   (2, [4, 4, 8], 2, 0)], 4, 3),
    "moe_int4": (MOE4, MOE_CFG, [(0, [5, 9, 2, 7], 6, 0),
                                 (1, list(range(3, 12)), 5, 0)], 3, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_graph_step_equals_chunk_kernel(stand_in, name):
    """From one mid-serve pool state, a chunk through the pool's captured
    step (warm-up, then replays of _paged_graph_step over the static
    buffers) and a chunk through _paged_chunk_kernel on a clone of the
    pools: the same tokens and every pool byte equal."""
    params, cfg, specs, batch, rounds = CASES[name]
    pool = _mid_serve_pool(params, cfg, specs, batch, rounds)
    dec = pool._decoding()
    assert dec and len(dec) < batch  # dummy rows in the chunk
    chunk = pool._chunk_len(dec)
    bt, last, pos = pool._decode_inputs(dec, chunk)
    if name == "aliased_table":
        a, b = sorted((s for s in dec if s.rid in (0, 1)),
                      key=lambda s: s.rid)
        assert a.blocks[:2] == b.blocks[:2] and b.n_shared == 2
    else:
        assert chunk > min(s.remaining for s in dec)  # a row overshoots
    twin = _clone(pool.pools)
    want = tserving._paged_chunk_kernel(params, twin, bt, last, pos, cfg,
                                        chunk).tolist()
    pool._graphs = graphs.StepGraphs(stand_in[0])
    got = pool._decode_chunk(bt, last, pos, chunk)
    assert got == want
    _assert_pools_equal(pool.pools, twin)
    assert pool._graphs.stats == {"captured": 1, "capture_s":
                                  pool._graphs.stats["capture_s"],
                                  "replays": chunk - 1}
    # A second chunk at the same width replays only.
    pos2 = pos + chunk
    last2 = torch.tensor([row[-1] for row in got])
    want2 = tserving._paged_chunk_kernel(params, twin, bt, last2, pos2, cfg,
                                         chunk).tolist()
    assert pool._decode_chunk(bt, last2, pos2, chunk) == want2
    _assert_pools_equal(pool.pools, twin)
    assert pool._graphs.stats["captured"] == 1
    assert pool._graphs.stats["replays"] == 2 * chunk - 1


def test_graphed_serve_equals_eager_serve(stand_in):
    """Whole serves through the captured steps (several widths, prefix
    cache on) equal the eager serve in streams and accounting."""
    rng = np.random.default_rng(2)
    reqs = [tserving.Request(rid=i, tokens=SHARED[:int(rng.integers(2, 40))],
                             max_new=int(rng.integers(1, 14)))
            for i in range(7)]
    kw = dict(paged=True, kv_quant=True, block_size=16, prefill_budget=16,
              device="cpu")
    got_stats, want_stats = {}, {}
    got = tserving.serve(INT8, TCFG, reqs, 3, stats=got_stats, **kw)
    assert got_stats["graphs"]["captured"] >= 2
    stand_in[0] = None  # for_device now hands out no graphs to call
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "for_device", lambda device: None)
        want = tserving.serve(INT8, TCFG, reqs, 3, stats=want_stats, **kw)
    assert got == want
    assert "graphs" not in want_stats
    for key in ("rounds", "slot_steps", "prefix_hit_tokens", "cow_copies"):
        assert got_stats[key] == want_stats[key], key


def test_paged_capture_or_replay_failure_raises(stand_in, monkeypatch):
    """A failed capture or replay raises out of step_round; the chunk
    never continues on the eager loop."""
    eager = []
    monkeypatch.setattr(tserving, "_paged_chunk_kernel",
                        lambda *a: eager.append(a))
    for at in ("capture", "replay"):
        stand_in[0] = Failing(at)
        pool = tserving.PagedPool(INT8, TCFG, 2, block_size=16,
                                  kv_quant=True, device="cpu")
        pool.admit(tserving.Request(rid=0, tokens=[3, 4, 5], max_new=8))
        with pytest.raises(RuntimeError, match=f"stand-in {at} failed"):
            while pool.has_active():
                pool.step_round()
        assert pool.slots[0].generated == []  # nothing committed
    assert eager == []


# ---- generate ------------------------------------------------------------


@pytest.mark.parametrize("kv_quant,kv_kernel", [
    (True, True), (True, False), (False, False)],
    ids=["k5_plain", "int8_einsum", "float_einsum"])
def test_decode_step_tensor_position_is_bitwise_the_int_form(kv_quant,
                                                             kv_kernel):
    """decode_step at a 0-d tensor position: the same logits and cache
    bytes as at the int position, on K5's plain version and on the einsum
    path, including a position the write clamps."""
    prompt = torch.as_tensor(np.random.default_rng(1).integers(0, 64, (3, 5)))
    caches = tdecode.init_cache(TCFG, 3, 9, quantized=kv_quant,
                                device="cpu")
    logits, _ = tdecode.prefill(INT8, prompt, caches, TCFG,
                                kv_kernel=kv_kernel)
    tok = torch.argmax(logits, -1)
    twin = _clone(caches)
    for pos in (5, 6, 8, 11):
        a, _ = tdecode.decode_step(INT8, tok, pos, caches, TCFG,
                                   kv_kernel=kv_kernel)
        b, _ = tdecode.decode_step(INT8, tok, torch.tensor(pos), twin, TCFG,
                                   kv_kernel=kv_kernel)
        assert torch.equal(a, b), pos
        _assert_pools_equal(caches, twin)
        tok = torch.argmax(a, -1)


@pytest.mark.parametrize("params,kv_quant,kv_kernel", [
    (INT8, True, None), (INT8, True, False), (FLOAT, False, None)],
    ids=["k5_plain", "int8_einsum", "float"])
def test_graphed_generate_equals_eager(stand_in, params, kv_quant,
                                       kv_kernel):
    """generate through its captured step equals the eager loop bitwise;
    one capture a call, steps - 2 replays; steps 1 and 2 too."""
    prompt = np.random.default_rng(3).integers(0, 64, (2, 6))
    for steps in (1, 2, 7):
        stand_in[0] = Replaying()
        got = tdecode.generate(params, prompt, TCFG, steps, kv_quant=kv_quant,
                               kv_kernel=kv_kernel, device="cpu")
        assert stand_in[0].captures == (1 if steps > 1 else 0)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(graphs, "for_device", lambda device: None)
            want = tdecode.generate(params, prompt, TCFG, steps,
                                    kv_quant=kv_quant, kv_kernel=kv_kernel,
                                    device="cpu")
        assert torch.equal(got, want), steps


def test_ragged_generate_stays_eager(stand_in):
    """prompt_lengths (the slot engine's replays) runs the eager loop."""
    stand_in[0] = Failing("capture")
    out = tdecode.generate(INT8, [[0, 3, 4], [5, 6, 7]], TCFG, 4,
                           kv_quant=True, prompt_lengths=[2, 3],
                           device="cpu")
    assert out.shape == (2, 4)
    with pytest.raises(RuntimeError, match="stand-in capture failed"):
        tdecode.generate(INT8, [[0, 3, 4]], TCFG, 4, kv_quant=True,
                         device="cpu")


# ---- the helper ------------------------------------------------------------


def test_launch_counts_under_a_stand_in_capture(launches):
    """Warm-up, capture and replays count each step's launches once: the
    capture's counts are taken back out and every replay adds them."""
    backend = Counting()
    g = graphs.StepGraphs(backend)
    executed = []

    def body():
        kernels.LAUNCHES["paged_attention"] += 2
        kernels.LAUNCHES["int8_matmul"] += 5
        if not backend.capturing:
            executed.append(1)

    g.run("a", body, 4)
    assert len(executed) == 4
    assert (launches["paged_attention"], launches["int8_matmul"]) == (8, 20)
    assert g.stats["captured"] == 1 and g.stats["replays"] == 3
    g.run("a", body, 3)
    g.run("a", body, 0)
    assert len(executed) == 7
    assert (launches["paged_attention"], launches["int8_matmul"]) == (14, 35)
    assert g.stats["captured"] == 1 and g.stats["replays"] == 6
    kernels.reset_launches()  # a caller's reset between runs
    g.run("b", body, 1)
    g.run("a", body, 2)
    assert (launches["paged_attention"], launches["int8_matmul"]) == (6, 15)
    assert g.stats["captured"] == 2
    assert all(v == 0 for k, v in launches.items()
               if k not in ("paged_attention", "int8_matmul"))


def test_failed_capture_leaves_counts_and_raises(launches):
    g = graphs.StepGraphs(Failing("capture"))

    def body():
        kernels.LAUNCHES["decode_attention"] += 1

    with pytest.raises(RuntimeError, match="capture failed"):
        g.run("k", body, 5)
    assert launches["decode_attention"] == 1  # the warm-up only
    assert g.stats["captured"] == 0


def test_no_graphs_off_the_card():
    assert graphs.for_device(torch.device("cpu")) is None
    pool = tserving.PagedPool(INT8, TCFG, 1, kv_quant=True, device="cpu")
    assert pool._graphs is None


def test_commit_writes_and_advances():
    out = torch.zeros((2, 4), dtype=torch.long)
    tok, pos = torch.tensor([1, 2]), torch.tensor([5, 9])
    step = torch.tensor([1])
    graphs.commit(torch.tensor([7, 8]), tok, pos, out, step)
    assert out.tolist() == [[0, 7, 0, 0], [0, 8, 0, 0]]
    assert tok.tolist() == [7, 8] and pos.tolist() == [6, 10]
    assert step.tolist() == [2]
