"""Checkpoints, the per-rank batch cut, LoRA, QLoRA and distillation on a
mesh of gloo ranks, and the multiprocess dryrun, held to the port's
one-process runs and the JAX reference's contracts on the CPU:
tests/test_checkpoint.py, tests/test_data.py:69-75 and :112,
tests/test_lora.py:96, :121 and :218, tests/test_distill.py:158 and
tests/test_multihost_bootstrap.py:161-179.

Two module-scoped worlds (``tests/test_torch_mesh_ranks.py``): 8 ranks
on data=2, fsdp=2, tensor=2 (program ``mesh_finetune``) and 4 ranks on
data=2, tensor=2 (``file_resume``). Weights come from the reference's
``init_params`` through ``bridge.params_from_numpy``.

Tolerances: resumes bitwise (the reference's); LoRA and QLoRA against
one process 1e-5 relative and distillation 2e-5 (the reference's);
the dryrun's workers against ``reference_loss()`` 1e-5 relative
(``__graft_entry__.py:229-236``'s rule)."""

import subprocess
import time

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Shard

from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap_torch.workload import (bridge, distill, dryrun_mp, lora,
                                          model, quant, train)
from tpu_bootstrap_torch.workload.data import (DataConfig, TokenDataset,
                                               write_token_file)

from tests.test_torch_mesh_ranks import spawn_world

torch.set_num_threads(2)

CKPT_MODEL = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
                  embed_dim=16, mlp_dim=32, max_seq_len=16)
LORA_MODEL = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
                  embed_dim=32, mlp_dim=64, max_seq_len=16)
TEACHER = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8,
               embed_dim=32, mlp_dim=64, max_seq_len=48)
STUDENT = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=4,
               embed_dim=16, mlp_dim=32, max_seq_len=48)
LCFG = lora.LoraConfig(rank=4, alpha=8.0)


def _port(jparams):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "tokens.bin"
    write_token_file(path, np.random.default_rng(0).integers(0, 64,
                                                             size=4096))
    base = jmodel.init_params(jmodel.ModelConfig(**LORA_MODEL),
                              jax.random.PRNGKey(0))
    teacher = jmodel.init_params(jmodel.ModelConfig(**TEACHER),
                                 jax.random.PRNGKey(0))
    teacher = {**teacher, "embed": teacher["embed"] * 30.0}
    student = jmodel.init_params(jmodel.ModelConfig(**STUDENT),
                                 jax.random.PRNGKey(1))
    lora_tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, 64)
    distill_tokens = [jax.random.randint(jax.random.PRNGKey(100 + i),
                                         (8, 24), 0, 32) for i in range(3)]
    return {"token_file": str(path), "ckpt_model": CKPT_MODEL,
            "lora_model": LORA_MODEL, "base": _port(base),
            "lora_tokens": torch.tensor(np.asarray(lora_tokens)),
            "teacher_model": TEACHER, "student_model": STUDENT,
            "teacher": _port(teacher), "student": _port(student),
            "distill_tokens": [torch.tensor(np.asarray(t))
                               for t in distill_tokens]}


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    return spawn_world("mesh_finetune", 8, tmp_path_factory.mktemp("ft"),
                       inputs)


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return spawn_world("file_resume", 4, tmp_path_factory.mktemp("fr"),
                       inputs)


def test_resume_matches_uninterrupted(world):
    for r in world:
        assert len(r["full"]) == 6 and len(r["first"]) == 3
        assert r["first"] + r["resumed"] == r["full"]
        assert r["full"] == world[0]["full"]


def test_resume_at_target_is_noop(world):
    assert all(r["again"] == [] for r in world)


def test_checkpoint_restores_placements(world):
    """Restore reads the one file and places every leaf (and moment) by
    param_shardings; the values are the saved ones."""
    for r in world:
        assert r["restored_equal"] and r["restored_placed"]
        assert r["moments_placed"]


def test_rank_rows_reassemble_the_global_batch(world, inputs):
    want = TokenDataset(DataConfig(path=inputs["token_file"]),
                        seq_len=16).batch(5, 8)
    by_index = {}
    for r in world:
        assert r["rows_placed"] and r["dp"][1] == 4
        index = r["dp"][0]
        if index in by_index:  # tensor ranks read the same rows
            assert torch.equal(by_index[index], r["rows"])
        by_index[index] = r["rows"]
        np.testing.assert_array_equal(r["full_batch"].numpy(), want)
    got = torch.cat([by_index[i] for i in range(4)])
    np.testing.assert_array_equal(got.numpy(), want)


def test_train_loop_on_file_data_resumes_exactly(world4):
    """tests/test_data.py:112 on data=2, tensor=2: four ranks."""
    for r in world4:
        assert len(r["full"]) == 6 and np.isfinite(r["full"]).all()
        assert r["first"] + r["resumed"] == r["full"]


def _lora_single(inputs, base) -> list:
    cfg = train.TrainConfig(model=model.ModelConfig(**LORA_MODEL),
                            learning_rate=1e-2)
    step, opt = lora.make_lora_train_step(cfg, train.MeshConfig(), base,
                                          LCFG)
    adapters = lora.init_lora(base, LCFG, seed=2, device="cpu")
    opt_state = opt.init(adapters)
    losses = []
    for _ in range(3):
        adapters, opt_state, loss = step(adapters, opt_state,
                                         inputs["lora_tokens"])
        losses.append(float(loss))
    return losses


def test_lora_sharded_matches_single(world, inputs):
    want = _lora_single(inputs, inputs["base"])
    for r in world:
        np.testing.assert_allclose(r["lora"], want, rtol=1e-5)


def test_qlora_base_placed_and_matches_single(world, inputs):
    """The int8 base is placed before the step captures it: q's
    contraction dim over fsdp (tests/test_lora.py:121-150)."""
    want = _lora_single(inputs, quant.quantize_params(inputs["base"]))
    for r in world:
        np.testing.assert_allclose(r["qlora"], want, rtol=1e-5)
        placements, shape = r["qlora_wq"]
        assert placements[3] == Shard(0)  # fsdp
        assert shape == (LORA_MODEL["embed_dim"] // 2,
                         LORA_MODEL["num_heads"] * LORA_MODEL["head_dim"])


def test_lora_checkpoint_resume_on_mesh(world):
    for r in world:
        assert r["lora_resumed"] == r["lora_ckpt"][2:]


@pytest.mark.parametrize("as_arg", [False, True])
def test_distill_sharded_matches_single(world, inputs, as_arg):
    step, opt = distill.make_distill_step(
        model.ModelConfig(**STUDENT), inputs["teacher"],
        model.ModelConfig(**TEACHER), train.MeshConfig(), learning_rate=1e-2)
    student = jax.tree.map(lambda t: t.clone(), inputs["student"],
                           is_leaf=lambda t: isinstance(t, torch.Tensor))
    opt_state = opt.init(student)
    want = []
    for i in range(3):
        student, opt_state, loss = step(student, opt_state,
                                        inputs["distill_tokens"][i])
        want.append(float(loss))
    for r in world:
        np.testing.assert_allclose(r[("distill", as_arg)], want, rtol=2e-5)
        assert r["student_placed"]


def _dryrun_children() -> list:
    out = subprocess.run(["ps", "-eo", "args"], capture_output=True,
                         text=True).stdout
    return [ln for ln in out.splitlines()
            if "tpu_bootstrap_torch.workload.dryrun_mp" in ln]


def test_dryrun_mp_matches_one_process():
    """Eight processes rendezvoused from the JobSet env: every worker's
    loss equal, and equal to the one-process run's."""
    losses = dryrun_mp.run(timeout=240)
    assert len(losses) == dryrun_mp.PROCESSES
    assert len(set(losses)) == 1, losses
    np.testing.assert_allclose(losses[0], dryrun_mp.reference_loss(),
                               rtol=1e-5)
    assert _dryrun_children() == []


def test_dryrun_mp_failure_surfaces_and_reaps_workers():
    t0 = time.time()
    with pytest.raises(RuntimeError) as e:
        dryrun_mp.run(env_overrides={"TPUBC_NUM_HOSTS": "3"}, timeout=120)
    assert "worker 0 failed" in str(e.value)
    assert time.time() - t0 < 60
    assert _dryrun_children() == []
