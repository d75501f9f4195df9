"""The 1F1B schedule of the port's pipeline (``workload/pipeline.py``) on a
world of 8 gloo ranks, held to the JAX reference on the CPU: every 1F1B
case of tests/test_pipeline.py (:229-483, :581, :624's), the reference's
own ``make_pipeline_1f1b_grad`` on 8 XLA CPU devices with its stats and
``schedule``, ``pipeline_on_one_device`` against the world, and the
in-flight bound (at most P stage inputs, in place of the reference's XLA
memory analysis at :676).

The world and the reference's helpers are tests/test_torch_pipeline.py's
(program ``mesh_pipeline``); tolerances are the reference tests': losses
1e-5 relative, gradients 1e-4 relative and 1e-6 absolute (1e-5 absolute
under ``seq``; 2e-4 and 1e-5 for MoE), train steps 2e-5 against GPipe and
against one device (2e-4 under flash)."""

import jax
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import pipeline as jpipeline
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh as jbuild_mesh

from tests.test_torch_mesh_ranks import spawn_world
from tests.test_torch_pipeline import (
    BLOCK_LEAVES,
    MODEL,
    MOE_LEAVES,
    MOE_MODEL,
    SEQ_MODEL,
    assert_grads,
    aux_oracle,
    grad_case,
    jparams,
    port,
    reference_error,
    same_on_every_rank,
    single_losses,
    tokens_of,
    torch_tokens,
    value_and_grads,
)

torch.set_num_threads(2)

WORLD = 8
LOSS_CASES = [(2, 4, 4), (4, 2, 8)]
FSDP_MESHES = {"pp-dp-fsdp": dict(pipe=2, data=2, fsdp=2),
               "pp-fsdp-tp": dict(pipe=2, fsdp=2, tensor=2),
               "dcn-pp-fsdp": dict(dcn=2, pipe=2, fsdp=2)}
SEQ_CASES = {"pp-dp-sp-dense": (dict(pipe=2, data=2, seq=2), None, "dense"),
             "pp-dp-sp-flash": (dict(pipe=2, data=2, seq=2), None, "flash"),
             "pp-sp-tp": (dict(pipe=2, seq=2, tensor=2), None, "dense"),
             "pp-fsdp-sp": (dict(pipe=2, fsdp=2, seq=2), None, "dense"),
             "pp-sp-tp-mqa": (dict(pipe=2, seq=2, tensor=2), 1, "dense")}
MOE_MESHES = {"pp-dp-ep": dict(pipe=2, data=2, expert=2),
              "pp-ep-tp": dict(pipe=2, expert=2, tensor=2),
              "pp-fsdp-ep": dict(pipe=2, fsdp=2, expert=2),
              "pp-dp-moe": dict(pipe=2, data=4)}
AUX_MESHES = {"aux-pp-dp-ep": dict(pipe=2, data=2, expert=2),
              "aux-pp-ep-tp": dict(pipe=2, expert=2, tensor=2)}
AUX_MODEL = {**MOE_MODEL, "moe_aux_coef": 0.1}
OWN = dict(pipe=2, fsdp=2, tensor=2)
# worker_main's env on the world: the JobSet's knobs for a pipe mesh.
WORKER_ENV = {"WORKLOAD_MODE": "train", "WORKLOAD_STEPS": "2",
              "WORKLOAD_MODEL": ",".join(f"{k}={v}" for k, v in
                                         MODEL.items()),
              "WORKLOAD_MESH": "pipe=2,data=2,tensor=2",
              "WORKLOAD_LOG_EVERY": "1"}
WORKER = {"gpipe": WORKER_ENV,
          "1f1b": {**WORKER_ENV, "WORKLOAD_SCHEDULE": "1f1b",
                   "WORKLOAD_MICROBATCHES": "2"}}


def _dsz(mesh: dict) -> int:
    return (mesh.get("dcn", 1) * mesh.get("data", 1) * mesh.get("fsdp", 1)
            * mesh.get("expert", 1))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    refs, cases = {}, {}
    params = jparams(MODEL)
    one = dict(schedule="1f1b")
    for pipe, data, M in LOSS_CASES:
        tokens = tokens_of(1, M * data, MODEL)
        refs[("loss", pipe)] = value_and_grads(MODEL, params, tokens)
        cases[("loss", pipe)] = grad_case(MODEL, dict(pipe=pipe, data=data),
                                          params, tokens, M, **one)
    tokens16 = tokens_of(7, 16, MODEL)
    refs["single"] = single_losses(MODEL, tokens16, learning_rate=1e-2)
    train = dict(kind="train", model=MODEL, mesh=dict(pipe=2, data=4),
                 params=port(params), tokens=torch_tokens(tokens16), M=4,
                 lr=1e-2, steps=2, block=8)
    for attention in ("dense", "flash"):
        for schedule in ("1f1b", "gpipe"):
            cases[("train", attention, schedule)] = {
                **train, "attention": attention, "schedule": schedule}
    for kv in (None, 1):
        model = {**MODEL, "num_kv_heads": kv}
        p, tokens = jparams(model), tokens_of(1, 8, model)
        refs[("tp", kv)] = value_and_grads(model, p, tokens)
        cases[("tp", kv)] = grad_case(model, dict(pipe=2, data=2, tensor=2),
                                      p, tokens, 4, **one)
    refs["fsdp"] = value_and_grads(MODEL, params, tokens_of(1, 16, MODEL))
    for name, mesh in FSDP_MESHES.items():
        cases[name] = grad_case(MODEL, mesh, params, tokens_of(1, 16, MODEL),
                                4, **one)
    for name, (mesh, kv, attention) in SEQ_CASES.items():
        model = {**SEQ_MODEL, "num_kv_heads": kv}
        p, tokens = jparams(model), tokens_of(1, 4 * _dsz(mesh), model)
        refs[name] = value_and_grads(model, p, tokens)
        cases[name] = grad_case(model, mesh, p, tokens, 4,
                                attention=attention, block=8, **one)
    moe_params = jparams(MOE_MODEL)
    for name, mesh in MOE_MESHES.items():
        tokens = tokens_of(1, 2 * _dsz(mesh), MOE_MODEL)
        refs[name] = value_and_grads(MOE_MODEL, moe_params, tokens)
        cases[name] = grad_case(MOE_MODEL, mesh, moe_params, tokens, 2,
                                **one)
    aux_params = jparams(AUX_MODEL)
    for name, mesh in AUX_MESHES.items():
        tokens = tokens_of(1, 2 * _dsz(mesh), AUX_MODEL)
        oracle = aux_oracle(AUX_MODEL, M=2, dsz=_dsz(mesh))
        loss, g = jax.jit(jax.value_and_grad(oracle))(
            aux_params, tokens[:, :-1], tokens[:, 1:])
        refs[name] = (float(loss), jax.tree.map(np.asarray, {
            **g, "blocks": jpipeline.stack_block_params(g["blocks"])}))
        cases[name] = grad_case(AUX_MODEL, mesh, aux_params, tokens, 2,
                                **one)
        cases[(name, "gpipe")] = grad_case(AUX_MODEL, mesh, aux_params,
                                           tokens, 2)

    # The reference's own 1F1B on 8 XLA devices: loss, grads, stats.
    tokens8 = tokens_of(1, 8, MODEL)
    cfg = jtrain.TrainConfig(model=jmodel.ModelConfig(**MODEL),
                             mesh=JMesh(**OWN))
    grad_fn = jpipeline.make_pipeline_1f1b_grad(
        cfg, jbuild_mesh(cfg.mesh), num_microbatches=4)
    stacked = {**params, "blocks": jpipeline.stack_block_params(
        params["blocks"])}
    loss, g, stats = jax.jit(grad_fn)(stacked, tokens8[:, :-1],
                                      tokens8[:, 1:])
    refs["own"] = (float(loss), jax.tree.map(np.asarray, g),
                   {k: int(v) for k, v in stats.items()}, grad_fn.schedule)
    cases["own"] = grad_case(MODEL, OWN, params, tokens8, 4, **one)
    cases["remat"] = grad_case(MODEL, OWN, params, tokens8, 4, remat=True,
                               **one)

    cases["stash"] = grad_case(MODEL, dict(pipe=2, data=4), params,
                               tokens_of(3, 64, MODEL), 16, **one)
    cases["one-device"] = {**grad_case(MODEL, dict(pipe=4, data=2), params,
                                       tokens16, 4, **one),
                           "kind": "one_device"}
    cases["world"] = grad_case(MODEL, dict(pipe=4, data=2), params, tokens16,
                               4, **one)
    refs["errors"] = _errors(cases)
    world = spawn_world("mesh_pipeline", WORLD,
                        tmp_path_factory.mktemp("pipeline_1f1b"),
                        {"cases": cases, "worker": WORKER})
    return {"refs": refs, "world": world}


def _errors(cases: dict) -> dict:
    """The reference's refusals under 1F1B (:581, :624) and the world's
    cases that must raise them."""
    out = {}
    moe_seq = {**MOE_MODEL, "num_experts": 2, "max_seq_len": 17}
    specs = {"bad_seq": (MODEL, dict(pipe=2, data=2, seq=2), "1f1b"),
             "unknown_schedule": (MODEL, dict(pipe=2, data=4), "step"),
             "seq_moe": (moe_seq, dict(pipe=2, seq=2, expert=2), "1f1b")}
    for name, (model, mesh, call) in specs.items():
        schedule = "zigzag" if name == "unknown_schedule" else "gpipe"
        cfg = jtrain.TrainConfig(model=jmodel.ModelConfig(**model),
                                 mesh=JMesh(**mesh),
                                 pipeline_schedule=schedule)
        jmesh = jbuild_mesh(cfg.mesh)
        case = {"kind": "error", "model": model, "mesh": mesh, "M": 2,
                "call": call, "schedule": schedule}
        if name == "bad_seq":
            p = jmodel.init_params(cfg.model, jax.random.PRNGKey(0))
            stacked = {**p, "blocks": jpipeline.stack_block_params(
                p["blocks"])}
            tokens = tokens_of(1, 8, model)
            fn = jpipeline.make_pipeline_1f1b_grad(cfg, jmesh,
                                                   num_microbatches=2)
            out[name] = reference_error(
                lambda: fn(stacked, tokens[:, :-1], tokens[:, 1:]))
            case.update(params=port(p), tokens=torch_tokens(tokens))
        elif name == "unknown_schedule":
            _, _, p_sh = jtrain.init_train_state(cfg, jmesh,
                                                 jax.random.PRNGKey(0))
            out[name] = reference_error(
                lambda: jtrain.make_train_step(cfg, jmesh, p_sh))
        else:
            out[name] = reference_error(
                lambda: jpipeline.make_pipeline_1f1b_grad(
                    cfg, jmesh, num_microbatches=2))
        cases[("error", name)] = case
    return out


def _full_grads(ref, name, want, names, rtol, atol):
    assert_grads(ref["world"][0][name]["grads"], want, names, rtol, atol,
                 outer=("embed", "final_norm"))


@pytest.mark.parametrize("pipe,data,microbatches", LOSS_CASES)
def test_1f1b_loss_and_grads_match_sequential(ref, pipe, data, microbatches):
    """Loss and every gradient, embed and final_norm from the manual head
    and lookup backward, with exact tick accounting: 2M turns a stage of
    T = 2M + 2(P-1) ticks."""
    loss, want = ref["refs"][("loss", pipe)]
    assert same_on_every_rank(ref["world"], ("loss", pipe)) == \
        pytest.approx(loss, rel=1e-5)
    stats = ref["world"][0][("loss", pipe)]["stats"]
    assert stats["active_ticks"] == 2 * microbatches * pipe
    bubble = 1 - stats["active_ticks"] / stats["total_ticks"]
    assert bubble == pytest.approx((pipe - 1) / (microbatches + pipe - 1))
    _full_grads(ref, ("loss", pipe), want, BLOCK_LEAVES, 1e-4, 1e-6)


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_1f1b_train_step_matches_gpipe_and_single_device(ref, attention):
    world = ref["world"]
    got = same_on_every_rank(world, ("train", attention, "1f1b"), "losses")
    np.testing.assert_allclose(
        got, same_on_every_rank(world, ("train", attention, "gpipe"),
                                "losses"), rtol=2e-5)
    np.testing.assert_allclose(got, ref["refs"]["single"],
                               rtol=2e-4 if attention == "flash" else 2e-5)


@pytest.mark.parametrize("num_kv_heads", [None, 1])
def test_1f1b_with_tensor_parallelism_matches_sequential(ref, num_kv_heads):
    loss, want = ref["refs"][("tp", num_kv_heads)]
    name = ("tp", num_kv_heads)
    assert same_on_every_rank(ref["world"], name) == pytest.approx(
        loss, rel=1e-5)
    _full_grads(ref, name, want, BLOCK_LEAVES, 1e-4, 1e-6)


@pytest.mark.parametrize("mesh", sorted(FSDP_MESHES))
def test_1f1b_with_fsdp_matches_sequential(ref, mesh):
    loss, want = ref["refs"]["fsdp"]
    assert same_on_every_rank(ref["world"], mesh) == pytest.approx(
        loss, rel=1e-5)
    _full_grads(ref, mesh, want, BLOCK_LEAVES, 1e-4, 1e-6)


@pytest.mark.parametrize("name", sorted(SEQ_CASES))
def test_1f1b_with_seq_parallelism_matches_sequential(ref, name):
    """_gathered_kv_attention under dense and flash alike, as the
    reference runs it."""
    loss, want = ref["refs"][name]
    assert same_on_every_rank(ref["world"], name) == pytest.approx(
        loss, rel=1e-5)
    _full_grads(ref, name, want, BLOCK_LEAVES, 1e-4, 1e-5)


@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
def test_1f1b_with_moe_matches_sequential(ref, mesh):
    loss, want = ref["refs"][mesh]
    assert same_on_every_rank(ref["world"], mesh) == pytest.approx(
        loss, rel=1e-5)
    assert_grads(ref["world"][0][mesh]["grads"], want, MOE_LEAVES, 2e-4,
                 1e-5, outer=("embed",))


@pytest.mark.parametrize("mesh", sorted(AUX_MESHES))
def test_1f1b_moe_aux_matches_gpipe(ref, mesh):
    """aux_coef 0.1: 1F1B's seeded aux is GPipe's per-(microbatch, data
    shard) estimator (held to the reference's functions on each group's
    rows), loss and gradients, the router's included; with tensor 2 no
    factor of tp slips into the loss or the router."""
    world = ref["world"]
    loss, want = ref["refs"][mesh]
    got = same_on_every_rank(world, mesh)
    assert got == pytest.approx(loss, rel=1e-5)
    assert got == pytest.approx(same_on_every_rank(world, (mesh, "gpipe")),
                                rel=1e-5)
    assert_grads(world[0][mesh]["grads"], want, MOE_LEAVES, 2e-4, 1e-5,
                 outer=("embed",))
    for name in MOE_LEAVES:
        np.testing.assert_allclose(
            world[0][mesh]["grads"]["blocks"][name].numpy(),
            world[0][(mesh, "gpipe")]["grads"]["blocks"][name].numpy(),
            rtol=2e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", ["bad_seq", "unknown_schedule"])
def test_1f1b_rejects_bad_seq_and_unknown_schedules(ref, name):
    for r in ref["world"]:
        assert r[("error", name)]["error"] == ref["refs"]["errors"][name]


def test_1f1b_rejects_seq_with_moe(ref):
    for r in ref["world"]:
        assert r[("error", "seq_moe")]["error"] == \
            ref["refs"]["errors"]["seq_moe"]


def test_1f1b_matches_the_reference_schedule(ref):
    """The reference's own make_pipeline_1f1b_grad on 8 XLA devices (pipe
    2, fsdp 2, tensor 2, M 4): loss, every gradient, the tick stats and
    grad_fn.schedule."""
    loss, want, stats, schedule = ref["refs"]["own"]
    got = ref["world"][0]["own"]
    assert same_on_every_rank(ref["world"], "own") == pytest.approx(
        loss, rel=1e-5)
    _full_grads(ref, "own", want, BLOCK_LEAVES, 1e-4, 1e-6)
    assert {k: got["stats"][k] for k in stats} == stats
    assert got["schedule"] == schedule


def test_1f1b_remat_matches(ref):
    """Each layer checkpointed inside the B turn's recompute."""
    world = ref["world"]
    assert same_on_every_rank(world, "remat") == pytest.approx(
        same_on_every_rank(world, "own"), rel=1e-6)
    plain, remat = world[0]["own"]["grads"], world[0]["remat"]["grads"]
    for name in BLOCK_LEAVES:
        np.testing.assert_allclose(remat["blocks"][name].numpy(),
                                   plain["blocks"][name].numpy(), rtol=1e-6,
                                   atol=1e-8, err_msg=name)


def test_1f1b_holds_at_most_pipe_inputs(ref):
    """At M = 16 on two stages no stage holds more than P = 2 inputs for
    its B turns (GPipe holds 16, tests/test_torch_pipeline.py)."""
    stats = ref["world"][0]["stash"]["stats"]
    assert stats["peak_stash"] == 2
    assert stats["active_ticks"] == 2 * 16 * 2
    assert stats["total_ticks"] == (2 * 16 + 2 * (2 - 1)) * 2


def test_1f1b_on_one_device_matches_the_world(ref):
    """Four stages in one process against the world's pipe=4, data=2."""
    world = ref["world"]
    one = world[0]["one-device"]
    assert one["loss"] == pytest.approx(same_on_every_rank(world, "world"),
                                        rel=1e-6)
    got, want = one["grads"], world[0]["world"]["grads"]
    for name in BLOCK_LEAVES:
        np.testing.assert_allclose(got["blocks"][name].numpy(),
                                   want["blocks"][name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    for name in ("embed", "final_norm"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert one["stats"] == world[0]["world"]["stats"]


@pytest.mark.parametrize("schedule", sorted(WORKER))
def test_worker_main_trains_on_a_pipe_mesh(ref, schedule):
    """python -m tpu_bootstrap_torch.workload.train's entry with
    WORKLOAD_MESH=pipe=2,data=2,tensor=2 (and WORKLOAD_SCHEDULE /
    WORKLOAD_MICROBATCHES): two steps on the schedule named, M defaulting
    to twice the stages, the same losses on every rank."""
    want = (schedule, 2 if schedule == "1f1b" else 0)
    done = []
    for r in ref["world"]:
        got = r[("worker", schedule)]
        assert got["made"] == [want]
        lines = got["printed"].splitlines()
        assert lines[-1].startswith("train_loop done: ran 2 steps"), lines
        done.append(lines[-1])
        assert all("nan" not in line for line in lines)
    assert len(set(done)) == 1
