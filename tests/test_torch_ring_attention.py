"""Ring attention on gloo ranks, held to the JAX reference on the CPU:
tests/test_ring_attention.py (its nine tests) and tests/test_gqa.py:101-106
(the ring with GQA), the port's ``ring_attention.make_ring_attention``
with one port rank a reference device.

One module-scoped world of 8 ranks (``tests/test_torch_mesh_ranks.py``,
program ``ring``) runs every case on its mesh: n_seq shards over ``seq``
and the batch whole on the other axes' ranks, or heads over ``tensor``.
The inputs are made here with numpy from a seed, and the reference's
outputs and gradients (``jax.grad`` of sum(out^2) through its unsharded
``reference_attention``) are computed here on one JAX device. Each rank
reports its shard, and each test holds every rank's shard to the
reference's slice at the reference test's tolerance. The ring's backward
is hand-written (``ring_attention._Ring``) and issues the same sends on
every rank, so the world finishing is itself the check that the rank
which skips every earlier shard (rank 0 of each ring) runs its backward;
the spawner's timeout turns a hang into a failure.

``ring_on_one_device``, the one-process runner ``chip_smoke.py``'s ring
phase runs on the card, is held to the gloo ring bit for bit (rank 0
runs it on the same shards, one thread as every rank)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload.ring_attention import \
    make_ring_attention as jmake_ring
from tpu_bootstrap.workload.ring_attention import \
    reference_attention as jreference
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh as jbuild_mesh
from tpu_bootstrap_torch.workload import bridge, ring_attention

from tests.test_torch_mesh_ranks import spawn_world

torch.set_num_threads(2)

WORLD = 8
MODEL = dict(num_layers=2, max_seq_len=33)


def _qkv(seed, batch=2, seq=32, heads=4, head_dim=8, kv_heads=None,
         dtype=np.float32):
    rng = np.random.default_rng(seed)
    kv_heads = kv_heads or heads
    return tuple(rng.standard_normal((batch, seq, h, head_dim)).astype(dtype)
                 for h in (heads, kv_heads, kv_heads))


def _seq_mesh(n):
    return dict(data=WORLD // n, seq=n)


def _case(qkv, mesh, attention="dense", **kw):
    return {**{x: torch.tensor(np.array(a)) for x, a in zip("qkv", qkv)},
            "mesh": mesh, "attention": attention, **kw}


def _ref(qkv, grad=False):
    q, k, v = (jnp.asarray(x) for x in qkv)
    out = np.asarray(jreference(q, k, v), np.float32)
    if not grad:
        return {"out": out}
    grads = jax.grad(lambda q, k, v: jnp.sum(jnp.square(jreference(q, k, v))),
                     argnums=(0, 1, 2))(q, k, v)
    return {"out": out, "grads": [np.asarray(g) for g in grads]}


CASES = {}


def _add(name, qkv, mesh, attention="dense", grad=False, **kw):
    CASES[name] = (qkv, mesh, attention, grad, kw)


for n in (2, 4, 8):
    _add(f"dense{n}", _qkv(0), _seq_mesh(n))
for n in (2, 4):
    _add(f"flash{n}", _qkv(3), _seq_mesh(n), "flash", block_size=8)
_add("dense_grads", _qkv(1, seq=16), _seq_mesh(4), grad=True, lockstep=True)
_add("flash_grads", _qkv(4, seq=16), _seq_mesh(4), "flash", grad=True,
     block_size=8, lockstep=True)
_add("flash_odd", _qkv(5, seq=24), _seq_mesh(2), "flash", block_size=8)
_CAUSAL = _qkv(2, batch=1, seq=16)
_PERTURBED = (_CAUSAL[0], _CAUSAL[1].copy(), _CAUSAL[2].copy())
_PERTURBED[1][0, -1] += 1.0
_PERTURBED[2][0, -1] += 1.0
_add("causal_a", _CAUSAL, _seq_mesh(4))
_add("causal_b", _PERTURBED, _seq_mesh(4))
_add("tensor_heads", _qkv(4, batch=1, seq=16), dict(seq=4, tensor=2),
     heads=True)
for attention in ("dense", "flash"):
    _add(f"gqa_{attention}", _qkv(6, seq=16, kv_heads=2),
         dict(seq=4, tensor=2), attention, heads=True, block_size=8)


@pytest.fixture(scope="module")
def ref():
    """The reference's values and the world's inputs."""
    cases = {}
    refs = {name: _ref(qkv, grad) for name, (qkv, _, _, grad, _)
            in CASES.items()}
    for name, (qkv, mesh, attention, grad, kw) in CASES.items():
        cases[name] = _case(qkv, mesh, attention, grad=grad, **kw)
    bf16 = tuple(x.astype(np.float32) for x in _qkv(3))
    bf16 = tuple(np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
                 for x in bf16)
    cases["bf16"] = {**_case(bf16, _seq_mesh(4)), **{
        x: torch.tensor(np.array(a)).to(torch.bfloat16)
        for x, a in zip("qkv", bf16)}}
    refs["bf16"] = _ref(bf16)
    cfg = jmodel.ModelConfig(**MODEL)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 33), 0,
                                cfg.vocab_size)
    refs["model"] = float(jmodel.loss_fn(params, tokens, cfg))
    cases["model"] = {"mesh": _seq_mesh(4), "attention": "dense",
                      "model": MODEL, "tokens": torch.tensor(
                          np.asarray(tokens)),
                      "params": bridge.params_from_numpy(
                          jax.tree.map(np.asarray, params), device="cpu")}
    return {"refs": refs, "inputs": {"cases": cases}}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    return spawn_world("ring", WORLD, tmp_path_factory.mktemp("ring"),
                       ref["inputs"])


def _pieces(world, name):
    """Each rank's record of a case."""
    return [r[name] for r in world]


def _slice(x, rec, case_mesh, heads):
    n = case_mesh["seq"]
    x = np.split(x, n, axis=1)[rec["seq"]]
    if heads:
        x = np.split(x, case_mesh["tensor"], axis=2)[rec["tensor"]]
    return x


def _hold(ref, world, name, atol, rtol=0.0, grads_atol=None):
    qkv, mesh, _, grad, kw = CASES[name]
    want = ref["refs"][name]
    for rec in _pieces(world, name):
        np.testing.assert_allclose(
            rec["out"].float().numpy(),
            _slice(want["out"], rec, mesh, kw.get("heads")), atol=atol,
            rtol=rtol)
        if grad:
            for g, w in zip(rec["grads"], want["grads"]):
                np.testing.assert_allclose(
                    g.numpy(), _slice(w, rec, mesh, kw.get("heads")),
                    atol=grads_atol)


@pytest.mark.parametrize("n_seq", [2, 4, 8])
def test_ring_matches_reference(ref, world, n_seq):
    _hold(ref, world, f"dense{n_seq}", atol=1e-5)


def test_ring_gradients_match_reference(ref, world):
    """Every rank's dq, dk, dv against the reference's gradients, rank 0
    (whose earlier folds are all skipped) included."""
    _hold(ref, world, "dense_grads", atol=1e-5, grads_atol=1e-4)
    assert {rec["seq"] for rec in _pieces(world, "dense_grads")} == {0, 1,
                                                                     2, 3}


@pytest.mark.parametrize("n_seq", [2, 4])
def test_ring_flash_matches_reference(ref, world, n_seq):
    _hold(ref, world, f"flash{n_seq}", atol=1e-5)


def test_ring_flash_gradients_match_reference(ref, world):
    _hold(ref, world, "flash_grads", atol=1e-5, grads_atol=1e-4)


def test_ring_flash_odd_shard_length(ref, world):
    """12 positions a shard with block 8."""
    _hold(ref, world, "flash_odd", atol=1e-5)


def test_ring_is_causal(world):
    """Perturbing the last position's k and v changes no earlier output."""
    a = {rec["seq"]: rec["out"].numpy() for rec in _pieces(world,
                                                           "causal_a")}
    b = {rec["seq"]: rec["out"].numpy() for rec in _pieces(world,
                                                           "causal_b")}
    out_a = np.concatenate([a[i] for i in range(4)], axis=1)
    out_b = np.concatenate([b[i] for i in range(4)], axis=1)
    np.testing.assert_allclose(out_a[0, :-1], out_b[0, :-1], atol=1e-5)
    assert not np.allclose(out_a[0, -1], out_b[0, -1])


def test_ring_bfloat16_inputs(ref, world):
    """bf16 activations with f32 accumulation inside the fold."""
    for rec in _pieces(world, "bf16"):
        assert rec["out"].dtype == torch.bfloat16
        want = np.split(ref["refs"]["bf16"]["out"], 4, axis=1)[rec["seq"]]
        np.testing.assert_allclose(rec["out"].float().numpy(), want,
                                   atol=3e-2)


def test_ring_composes_with_tensor_parallel_heads(ref, world):
    """seq=4 x tensor=2: each rank's ring runs on its heads."""
    _hold(ref, world, "tensor_heads", atol=1e-5)


def test_full_model_with_ring_attention(ref, world):
    """The model's loss on 4 sequence shards at their global positions
    (rotary), the shares summed over the ring, against the reference's
    unsharded loss."""
    for rec in _pieces(world, "model"):
        assert abs(rec["loss_share"] - ref["refs"]["model"]) < 1e-4


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_gqa_ring_matches_reference(ref, world, attention):
    """tests/test_gqa.py:101-106: two KV heads on seq=4 x tensor=2, one
    KV head a rank, rotated unexpanded."""
    qkv, mesh, _, _, kw = CASES[f"gqa_{attention}"]
    want = ref["refs"][f"gqa_{attention}"]["out"]
    for rec in _pieces(world, f"gqa_{attention}"):
        np.testing.assert_allclose(rec["out"].numpy(),
                                   _slice(want, rec, mesh, True),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_one_device_ring_equals_the_gloo_ring_bitwise(world, attention):
    """ring_on_one_device (the card's ring phase) gives every shard's out,
    dq, dk and dv bit for bit as the P2P ring's ranks do."""
    name = f"{attention}_grads"
    outs, grads = world[0][name]["lockstep"]
    for rec in _pieces(world, name):
        i = rec["seq"]
        assert torch.equal(outs[i], rec["out"])
        for mine, one in zip(rec["grads"], grads):
            assert torch.equal(mine, one[i])


def test_unknown_core_raises_the_reference_error():
    mesh = jbuild_mesh(JMesh())
    with pytest.raises(ValueError) as want:
        jmake_ring(mesh, attention="bogus")
    with pytest.raises(ValueError) as got:
        ring_attention.make_ring_attention(None, attention="bogus")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown attention"):
        ring_attention.ring_on_one_device([], [], [], None, "bogus")


def test_reference_attention_matches_the_reference():
    """The port's unsharded oracle, GQA and causal or not."""
    q, k, v = _qkv(7, seq=16, kv_heads=2)
    for causal in (True, False):
        want = np.asarray(jreference(*(jnp.asarray(x) for x in (q, k, v)),
                                     causal=causal))
        got = ring_attention.reference_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_public_names():
    assert ring_attention.__all__ == ["make_ring_attention",
                                      "reference_attention"]
