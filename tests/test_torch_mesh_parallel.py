"""Sequence and expert parallelism on a mesh of gloo ranks, held to the JAX
reference's single-device steps on the CPU: tests/test_seq_parallel_train.py
(five meshes and flash under ``seq``), tests/test_moe.py:145-210 (four
expert-parallel meshes and three ``expert`` x ``seq`` meshes),
tests/test_gqa.py:108-161's ``seq`` cases, a ``remat`` step on a ``seq``
mesh, LoRA on a ``seq`` mesh (tests/test_lora.py:96's check) and
distillation from an MoE teacher on an ``expert`` x ``seq`` mesh
(tests/test_distill.py:158's).

One module-scoped world of 8 ranks (``tests/test_torch_mesh_ranks.py``,
program ``mesh_parallel``) runs every case; the reference's losses are
computed here on one JAX device from the same params (its own init,
carried over by ``bridge.params_from_numpy``) and tokens.

Tolerances are the reference tests': ``seq`` meshes 1e-4 (absolute and
relative), expert meshes 2e-5 relative, ``expert`` x ``seq`` 2e-5 dense
and 2e-3 flash, GQA and MQA 2e-5, LoRA 1e-5, distillation 2e-5, remat
against no remat 1e-5. The ``expert`` x ``seq`` model's capacity factor
is 0.75 (the reference test's is 2.0, under which no token is dropped):
6 slots an expert for a row's 16 tokens, so capacity binds, and routing
a rank's 8 positions alone would give other drops. Where capacity binds,
a token whose two gates nearly tie can flip its expert under float noise
and move every later token's slot: at 0.5 one layer's gates came 1.2e-6
apart after the first update, the mesh's gradient sums (in another order
than one device's) flipped that token, and the second loss moved 3.3e-5
relative. So the test also holds every token's gate margin, on one
device's steps, above MOE_MARGIN."""

import jax
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import distill as jdistill
from tpu_bootstrap.workload import lora as jlora
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh as jbuild_mesh
from tpu_bootstrap_torch.workload import bridge, moe

from tests.test_torch_mesh_ranks import spawn_world

torch.set_num_threads(2)

WORLD = 8
SEQ_MODEL = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
                 embed_dim=32, mlp_dim=64, max_seq_len=33)
MOE_MODEL = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
                 embed_dim=32, mlp_dim=64, max_seq_len=17, num_experts=4,
                 expert_top_k=2, expert_capacity_factor=2.0)
MOE_SEQ_MODEL = {**MOE_MODEL, "num_experts": 2, "expert_top_k": 1,
                 "expert_capacity_factor": 0.75}
MOE_MARGIN = 1e-4  # least |gate_0 - gate_1| over tokens, steps and layers
GQA_MODEL = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
                 embed_dim=32, mlp_dim=64, max_seq_len=17, num_kv_heads=2)
MQA_MODEL = {**GQA_MODEL, "num_kv_heads": 1}
LORA_MODEL = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
                  embed_dim=32, mlp_dim=64, max_seq_len=16)
TEACHER = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
               embed_dim=32, mlp_dim=64, max_seq_len=48, num_experts=4)
STUDENT = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=4,
               embed_dim=16, mlp_dim=32, max_seq_len=48)

SEQ_MESHES = {"dp-sp-tp": dict(data=2, seq=2, tensor=2),
              "fsdp-sp-tp": dict(fsdp=2, seq=2, tensor=2),
              "sp4-tp": dict(seq=4, tensor=2),
              "dcn-fsdp-tp": dict(dcn=2, fsdp=2, tensor=2),
              "dcn-sp-tp": dict(dcn=2, seq=2, tensor=2)}
EP_MESHES = {"ep-tp": dict(expert=4, tensor=2),
             "dp-ep-tp": dict(data=2, expert=2, tensor=2),
             "fsdp-ep": dict(fsdp=2, expert=4),
             "dcn-dp-ep": dict(dcn=2, data=2, expert=2)}
EP_SEQ = {"ep-sp-tp-flash": (dict(expert=2, seq=2, tensor=2), "flash"),
          "dp-ep-sp-dense": (dict(data=2, expert=2, seq=2), "dense"),
          "dp-ep-sp-flash": (dict(data=2, expert=2, seq=2), "flash")}
SP = dict(data=2, seq=2, tensor=2)


def _port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


def _reference(model: dict, tokens, steps: int = 2, **kw) -> tuple:
    """(the reference's init carried over, its single-device losses)."""
    cfg = jtrain.TrainConfig(model=jmodel.ModelConfig(**model), **kw)
    mesh = jbuild_mesh(JMesh())
    params, opt_state, p_sh = jtrain.init_train_state(
        cfg, mesh, jax.random.PRNGKey(0))
    start = _port(params)
    step = jtrain.make_train_step(cfg, mesh, p_sh)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return start, losses


def _gate_margins(model: dict, params, tokens, steps: int = 2) -> list:
    """Every MoE layer's least top-1 gate margin and kept slots, step by
    step, on the port's one-device steps (the reference's losses to
    1e-7)."""
    import copy

    from tpu_bootstrap_torch.workload import model as tmodel
    from tpu_bootstrap_torch.workload import train as ttrain

    cfg = ttrain.TrainConfig(model=tmodel.ModelConfig(**model),
                             learning_rate=1e-2)
    params = copy.deepcopy(params)
    opt_state = ttrain.make_optimizer(cfg).init(params)
    step, found, route = ttrain.make_train_step(cfg), [], moe._route

    def watched(block, h, cfg_, batch_mean=None):
        dispatch, combine, aux = route(block, h, cfg_, batch_mean)
        gates = torch.softmax(torch.einsum(
            "bsm,me->bse", h.detach().float(),
            block["router"].detach().float()), -1)
        found.append((float((gates[..., 0] - gates[..., 1]).abs().min()),
                      int(dispatch.sum())))
        return dispatch, combine, aux

    moe._route = watched
    try:
        for _ in range(steps):
            params, opt_state, _ = step(params, opt_state, tokens)
    finally:
        moe._route = route
    return found


def _tokens(key: int, rows: int, model: dict):
    return jax.random.randint(jax.random.PRNGKey(key),
                              (rows, model["max_seq_len"]), 0,
                              model["vocab_size"])


@pytest.fixture(scope="module")
def ref():
    """The reference's values and the world's inputs."""
    refs, train = {}, {}

    def cases(model, tokens, meshes: dict, lr=None, **kw):
        lr_kw = {} if lr is None else {"learning_rate": lr}
        start, losses = _reference(model, tokens, **lr_kw)
        for name, (mesh, case_kw) in meshes.items():
            train[name] = {"model": model, "mesh": mesh, "params": start,
                           "tokens": torch.tensor(np.asarray(tokens)),
                           "steps": 2, **({"lr": lr} if lr else {}),
                           **kw, **case_kw}
            refs[name] = losses

    seq_tokens = _tokens(1, 4, SEQ_MODEL)
    cases(SEQ_MODEL, seq_tokens, {
        **{name: (mesh, {}) for name, mesh in SEQ_MESHES.items()},
        "sp-flash": (SP, {"attention": "flash", "block": 8}),
        "sp-remat": (SP, {"remat": True})})
    cases(MOE_MODEL, _tokens(7, 8, MOE_MODEL),
          {name: (mesh, {}) for name, mesh in EP_MESHES.items()}, lr=1e-2)
    cases(MOE_SEQ_MODEL, _tokens(7, 8, MOE_SEQ_MODEL),
          {name: (mesh, {"attention": attn, "block": 8})
           for name, (mesh, attn) in EP_SEQ.items()}, lr=1e-2)
    some = train[next(iter(EP_SEQ))]
    refs["margins"] = _gate_margins(MOE_SEQ_MODEL, some["params"],
                                    some["tokens"])
    cases(GQA_MODEL, _tokens(7, 8, GQA_MODEL),
          {"gqa-sp-flash": (SP, {"attention": "flash", "block": 8})}, lr=1e-2)
    cases(MQA_MODEL, _tokens(7, 8, MQA_MODEL),
          {"mqa-sp-flash": (SP, {"attention": "flash", "block": 8})}, lr=1e-2)

    bad = dict(model={**SEQ_MODEL, "max_seq_len": 32}, mesh=dict(data=4,
                                                                seq=2))
    with pytest.raises(ValueError) as seq_error:
        jtrain.make_train_step(
            jtrain.TrainConfig(model=jmodel.ModelConfig(**bad["model"]),
                               mesh=JMesh(**bad["mesh"])),
            jbuild_mesh(JMesh(**bad["mesh"])), None)
    refs["seq_error"] = str(seq_error.value)

    lcfg = dict(rank=4, alpha=8.0)
    base = jmodel.init_params(jmodel.ModelConfig(**LORA_MODEL),
                              jax.random.PRNGKey(0))
    adapters = jlora.init_lora(base, jlora.LoraConfig(**lcfg),
                               jax.random.PRNGKey(2))
    lora_tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 64)
    step, opt = jlora.make_lora_train_step(
        jtrain.TrainConfig(model=jmodel.ModelConfig(**LORA_MODEL),
                           learning_rate=1e-2), jbuild_mesh(JMesh()), base,
        jlora.LoraConfig(**lcfg))
    lora_case = {"model": LORA_MODEL, "mesh": SP, "lr": 1e-2, "steps": 3,
                 "lcfg": lcfg, "base": _port(base),
                 "adapters": _port(adapters),
                 "tokens": torch.tensor(np.asarray(lora_tokens))}
    state, refs["lora"] = opt.init(adapters), []
    for _ in range(3):
        adapters, state, loss = step(adapters, state, lora_tokens)
        refs["lora"].append(float(loss))

    teacher = jmodel.init_params(jmodel.ModelConfig(**TEACHER),
                                 jax.random.PRNGKey(0))
    student = jmodel.init_params(jmodel.ModelConfig(**STUDENT),
                                 jax.random.PRNGKey(1))
    distill_tokens = [jax.random.randint(jax.random.PRNGKey(100 + i),
                                         (8, 24), 0, 32) for i in range(3)]
    distill_case = {"teacher_model": TEACHER, "student_model": STUDENT,
                    "mesh": dict(data=2, expert=2, seq=2), "lr": 1e-2,
                    "teacher": _port(teacher), "student": _port(student),
                    "tokens": [torch.tensor(np.asarray(t))
                               for t in distill_tokens]}
    step, opt = jdistill.make_distill_step(
        jmodel.ModelConfig(**STUDENT), teacher, jmodel.ModelConfig(**TEACHER),
        jbuild_mesh(JMesh()), learning_rate=1e-2)
    state, refs["distill"] = opt.init(student), []
    for t in distill_tokens:
        student, state, loss = step(student, state, t)
        refs["distill"].append(float(loss))
    return {"refs": refs, "inputs": {
        "train": train, "probe": "ep-tp", "seq_error": bad,
        "lora": lora_case, "distill": distill_case}}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    return spawn_world("mesh_parallel", WORLD,
                       tmp_path_factory.mktemp("parallel"), ref["inputs"])


def _losses(world, name) -> list:
    """The case's losses, equal on every rank."""
    got = [r[("train", name)] for r in world]
    assert all(g == got[0] for g in got), got
    return got[0]


@pytest.mark.parametrize("mesh", sorted(SEQ_MESHES))
def test_seq_parallel_matches_single_device(ref, world, mesh):
    np.testing.assert_allclose(_losses(world, mesh), ref["refs"][mesh],
                               atol=1e-4, rtol=1e-4)


def test_flash_composes_with_seq_parallel(ref, world):
    """The ring on K3/K4's plain versions as its block core."""
    np.testing.assert_allclose(_losses(world, "sp-flash"),
                               ref["refs"]["sp-flash"], atol=1e-4,
                               rtol=1e-4)


def test_remat_on_a_seq_mesh(ref, world):
    """Non-reentrant checkpointing reruns the ring's P2P forward inside
    the backward on every rank: the losses stay the reference's and the
    step without remat's."""
    remat = _losses(world, "sp-remat")
    np.testing.assert_allclose(remat, ref["refs"]["sp-remat"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(remat, _losses(world, "dp-sp-tp"), atol=1e-5)


@pytest.mark.parametrize("mesh", sorted(EP_MESHES))
def test_expert_parallel_matches_single_device(ref, world, mesh):
    np.testing.assert_allclose(_losses(world, mesh), ref["refs"][mesh],
                               rtol=2e-5)


def test_expert_rank_holds_its_experts(world):
    """On expert=4, tensor=2 each rank keeps 1 of the 4 experts (and half
    the MLP width) of w_up, and a step gathers nothing over ``expert``:
    the slots travel by the all-to-all instead."""
    for r in world:
        probe = r["probe"]
        assert probe["local_w_up"] == (1, 32, 32)
        assert "expert" not in probe["gathers"]
        assert "tensor" in probe["gathers"]


@pytest.mark.parametrize("mesh", sorted(EP_SEQ))
def test_moe_composes_with_ring_attention(ref, world, mesh):
    """expert x seq with a binding capacity: the MoE layer routes whole
    rows (gathered over seq) as the reference's GSPMD step does. Capacity
    binds at both steps (fewer slots kept than the 8 x 16 tokens) and no
    token's gates lie within MOE_MARGIN."""
    tokens = 8 * (MOE_SEQ_MODEL["max_seq_len"] - 1)
    for margin, kept in ref["refs"]["margins"]:
        assert kept < tokens and margin > MOE_MARGIN
    rtol = 2e-3 if EP_SEQ[mesh][1] == "flash" else 2e-5
    np.testing.assert_allclose(_losses(world, mesh), ref["refs"][mesh],
                               rtol=rtol)


@pytest.mark.parametrize("name", ["gqa-sp-flash", "mqa-sp-flash"])
def test_gqa_train_step_on_the_ring_matches_single_device(ref, world, name):
    """tests/test_gqa.py:108-161: two KV heads, one a tensor rank, and MQA
    (one KV head, expanded before the heads split) on the flash ring."""
    np.testing.assert_allclose(_losses(world, name), ref["refs"][name],
                               rtol=2e-5)


def test_seq_needs_shifted_length_divisible(ref, world):
    for r in world:
        assert r["seq_error"] == ref["refs"]["seq_error"]


def test_lora_on_a_seq_mesh_matches_single_device(ref, world):
    """Whole rows on every seq rank, as the reference's step; the
    adapters' gradients summed over the batch axes and seq."""
    for r in world:
        np.testing.assert_allclose(r["lora"], ref["refs"]["lora"],
                                   rtol=1e-5)


def test_distill_from_an_moe_teacher_on_expert_seq(ref, world):
    for r in world:
        np.testing.assert_allclose(r["distill"], ref["refs"]["distill"],
                                   rtol=2e-5)
