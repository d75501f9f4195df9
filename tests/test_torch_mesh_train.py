"""Training on a mesh of gloo ranks, held to the JAX reference on the CPU:
the reference's sharded-workload tests (tests/test_workload.py:45-120)
with one port rank a reference device.

One module-scoped world of 8 ranks (``tests/test_torch_mesh_ranks.py``,
program ``mesh_train``) runs every case; the reference's values are
computed here, in the test process, and each test asserts its own case.
Params come from the reference's ``init_params`` through
``bridge.params_from_numpy`` and are placed by ``sharding.shard_params``.

Tolerances: a mesh's loss against the reference's single-device loss
1e-4 absolute (the reference test's own); mesh runs against the port's
one-process runs 1e-5 relative (sums over ranks taken in another order);
remat against no remat 1e-5 (the reference's)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap.workload.sharding import MeshConfig as JMesh
from tpu_bootstrap.workload.sharding import build_mesh as jbuild_mesh
from tpu_bootstrap.workload.sharding import param_shardings as jshardings
from tpu_bootstrap.workload.sharding import shard_params as jshard
from tpu_bootstrap_torch.workload import bridge
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import train as ttrain
from tpu_bootstrap_torch.workload.sharding import MeshConfig

from tests.test_torch_mesh_ranks import spawn_world

torch.set_num_threads(2)

WORLD = 8
MODEL = dict(num_layers=2, num_heads=4)
MQA = dict(num_layers=2, num_heads=4, num_kv_heads=1)
LOOP = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
            embed_dim=16, mlp_dim=32, max_seq_len=16)
MOE = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=8,
           embed_dim=32, mlp_dim=32, max_seq_len=33, num_experts=4)
LOSS_MESHES = {"data": dict(data=8), "fsdp": dict(fsdp=8),
               "tensor_data": dict(tensor=4, data=2),
               "3d": dict(data=2, fsdp=2, tensor=2)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(jparams):
    return bridge.params_from_numpy(_np(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref():
    """The reference's values and the world's inputs."""
    cfg = jmodel.ModelConfig(**MODEL)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0,
                                cfg.vocab_size)
    tokens64 = jax.random.randint(jax.random.PRNGKey(1), (8, 64), 0,
                                  cfg.vocab_size)
    mqa_cfg = jmodel.ModelConfig(**MQA)
    mqa = jmodel.init_params(mqa_cfg, jax.random.PRNGKey(0))
    mesh = jbuild_mesh(JMesh(data=2, fsdp=2, tensor=2))
    sharded = jshard(params, jshardings(mesh, params))
    shapes = {}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        else:
            shapes[path] = {tuple(s.data.shape)
                            for s in tree.addressable_shards}

    walk(sharded)
    flash_cfg = jtrain.TrainConfig(model=cfg, attention="flash",
                                   mesh=JMesh(tensor=8))
    with pytest.raises(ValueError) as heads_error:
        jtrain.make_train_step(flash_cfg, jbuild_mesh(flash_cfg.mesh), None)
    return {"loss": float(jmodel.loss_fn(params, tokens, cfg)),
            "mqa_dense_loss": float(jmodel.loss_fn(mqa, tokens, mqa_cfg)),
            "shard_shapes": shapes, "heads_error": str(heads_error.value),
            "inputs": {"model": MODEL, "params": _port(params),
                       "tokens": torch.tensor(np.asarray(tokens)),
                       "tokens64": torch.tensor(np.asarray(tokens64)),
                       "loss_meshes": LOSS_MESHES, "mqa_model": MQA,
                       "mqa_params": _port(mqa), "loop_model": LOOP,
                       "moe_model": MOE}}


@pytest.fixture(scope="module")
def world(ref, tmp_path_factory):
    return spawn_world("mesh_train", WORLD, tmp_path_factory.mktemp("mesh"),
                       ref["inputs"])


@pytest.mark.parametrize("mesh", sorted(LOSS_MESHES))
def test_sharded_loss_matches_single_device(ref, world, mesh):
    """tests/test_workload.py:45-73: any mesh gives the single device's
    loss; every rank reports the same (whole batch's) loss."""
    losses = {r[("loss", mesh)] for r in world}
    assert len(losses) == 1
    assert abs(losses.pop() - ref["loss"]) < 1e-4


def test_local_shard_shapes_match_reference(ref, world):
    """tests/test_workload.py:75-83, for every leaf: each rank's local
    shard has the reference's addressable shard shape."""
    for r in world:
        assert r["placements"]
        assert set(r["local_shapes"]) == set(ref["shard_shapes"])
        for path, shape in r["local_shapes"].items():
            assert ref["shard_shapes"][path] == {shape}, path
    wq = world[0]["local_shapes"]["/blocks/0/wq"]
    assert wq == (64 // 2, 4 // 2, 16)


def test_train_step_descends(world):
    for r in world:
        assert r["descend"] == world[0]["descend"]
    losses = world[0]["descend"]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_remat_matches_no_remat(world):
    plain, remat = world[0]["remat"]
    assert abs(plain - remat) < 1e-5


def test_flash_mqa_over_tensor_matches_dense_single_device(ref, world):
    """Flash under tensor=2 with one KV head: k and v expanded to the query
    heads before the heads are split (the reference's repeat_kv rule)."""
    for r in world:
        assert abs(r["flash_mqa"] - ref["mqa_dense_loss"]) < 1e-4


def test_heads_not_divisible_by_tensor_raises(ref, world):
    assert world[0]["heads_error"] == ref["heads_error"]


def test_run_demo_over_the_world(world):
    for r in world:
        assert len(r["run_demo"]) == 2 and all(np.isfinite(r["run_demo"]))
        assert r["run_demo"] == world[0]["run_demo"]


def _one_process(cfg, steps: int, batch_cfg, seed: int = 0) -> list:
    """The port's one-process run on the mesh run's global batches."""
    plain = dataclasses.replace(cfg, mesh=MeshConfig())
    params, opt_state = ttrain.init_train_state(plain, seed, "cpu")
    step = ttrain.make_train_step(plain)
    losses = []
    for i in range(steps):
        tokens = batch_cfg(i)
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    return losses


def test_train_loop_matches_one_process(world):
    cfg = ttrain.TrainConfig(model=tmodel.ModelConfig(**LOOP),
                             mesh=MeshConfig(data=2, fsdp=2, tensor=2),
                             grad_clip_norm=1.0, warmup_steps=1,
                             total_steps=4)
    want = _one_process(cfg, 2, lambda i: ttrain.synthetic_batch(cfg, i, 0))
    for r in world:
        np.testing.assert_allclose(r["loop"], want, rtol=1e-5)


def test_moe_aux_over_the_whole_batch(ref, world):
    """MoE's load-balancing aux takes its routing means over the whole
    batch, so three steps on data=4, tensor=2 follow one process's."""
    cfg = ttrain.TrainConfig(model=tmodel.ModelConfig(**MOE),
                             learning_rate=1e-2)
    tokens = ref["inputs"]["tokens"]
    want = _one_process(cfg, 3, lambda i: tokens, seed=3)
    for r in world:
        np.testing.assert_allclose(r["moe"], want, rtol=1e-5)
    assert sorted(r["dp"] for r in world) == sorted(
        (i, 4) for i in range(4) for _ in range(2))
