"""The mesh half of the port's training held to the JAX reference without a
process group: ``sharding.param_specs`` against the reference's
``param_shardings(...).spec`` leaf by leaf, the ``for_device_count`` pins
(tests/test_mesh_scale.py:33-51), ``build_mesh``'s refusals, the JobSet
rendezvous dict (tests/test_multihost_bootstrap.py:46-78, the env written
out), the per-host row cut (tests/test_data.py:59-67), the pipelined batch
size and the WORKLOAD_MICROBATCHES / WORKLOAD_SCHEDULE parse."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import data as jdata
from tpu_bootstrap.workload import model as jmodel
from tpu_bootstrap.workload import quant as jquant
from tpu_bootstrap.workload import sharding as jsharding
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap.workload.pipeline import stack_block_params
from tpu_bootstrap_torch.workload import bridge, data, sharding, train

torch.set_num_threads(2)

SMALL = dict(vocab_size=64, num_layers=2, num_heads=4, head_dim=8,
             embed_dim=32, mlp_dim=64, max_seq_len=16)
TREES = {
    "dense": dict(SMALL),
    "gqa": dict(SMALL, num_kv_heads=2),
    "mqa": dict(SMALL, num_kv_heads=1),
    "gated": dict(SMALL, mlp_gated=True),
    "moe": dict(SMALL, num_experts=4),
    "int8": dict(SMALL),
    "int4": dict(SMALL),
    "int8_moe": dict(SMALL, num_experts=4),
    "stacked": dict(SMALL),
}
MESHES = {"data8": dict(data=8), "fsdp8": dict(fsdp=8),
          "tensor4_data2": dict(tensor=4, data=2),
          "3d": dict(data=2, fsdp=2, tensor=2),
          "fsdp2_expert4": dict(fsdp=2, expert=4),
          "pipe2_data2_tensor2": dict(pipe=2, data=2, tensor=2)}


def _tree(name: str):
    params = jmodel.init_params(jmodel.ModelConfig(**TREES[name]),
                                jax.random.PRNGKey(0))
    if name.startswith("int8"):
        params = jquant.quantize_params(params)
    elif name == "int4":
        params = jquant.quantize_params4(params)
    elif name == "stacked":
        params = {**params, "blocks": stack_block_params(params["blocks"])}
    return params


def _compare(ref, got, path=""):
    """Walk the reference's shardings and the port's specs together."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _compare(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)) and not isinstance(
            ref, jax.sharding.PartitionSpec):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _compare(a, b, f"{path}/{i}")
    elif hasattr(ref, "q") and hasattr(ref, "s"):
        assert tuple(ref.q.spec) == got.q, f"{path}.q"
        assert tuple(ref.s.spec) == got.s, f"{path}.s"
    else:
        assert tuple(ref.spec) == got, path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_param_specs_match_reference(tree, mesh):
    jparams = _tree(tree)
    jmesh = jsharding.build_mesh(jsharding.MeshConfig(**MESHES[mesh]))
    want = jsharding.param_shardings(jmesh, jparams)
    port = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    got = sharding.param_specs(sharding.MeshConfig(**MESHES[mesh]), port)
    _compare(want, got)


PINS = {1: (1, 1, 1), 2: (1, 1, 2), 4: (1, 1, 4), 8: (1, 2, 4),
        16: (1, 4, 4), 32: (1, 8, 4), 64: (2, 8, 4), 128: (4, 8, 4),
        6: (3, 1, 2), 3: (3, 1, 1)}


@pytest.mark.parametrize("n", sorted(PINS))
def test_for_device_count_pins(n):
    data_, fsdp, tensor = PINS[n]
    cfg = sharding.MeshConfig.for_device_count(n)
    assert cfg == sharding.MeshConfig(data=data_, fsdp=fsdp, tensor=tensor)
    assert cfg.size == n
    ref = jsharding.MeshConfig.for_device_count(n)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert train.MeshConfig is sharding.MeshConfig


def test_build_mesh_without_a_process_group():
    """A size-1 config is the plain path (None, degenerate); a larger one
    raises the reference's words instead of training on one device."""
    assert not torch.distributed.is_initialized()
    assert sharding.build_mesh(sharding.MeshConfig()) is None
    assert sharding.degenerate_mesh(None)
    for cfg in (sharding.MeshConfig(data=2), sharding.MeshConfig(fsdp=8),
                sharding.MeshConfig(dcn=2, tensor=2)):
        with pytest.raises(ValueError,
                           match=f"mesh needs {cfg.size} devices, have 1"):
            sharding.build_mesh(cfg, "cpu")
    with pytest.raises(ValueError) as want:
        jsharding.build_mesh(jsharding.MeshConfig(data=16))
    with pytest.raises(ValueError) as got:
        sharding.build_mesh(sharding.MeshConfig(data=16))
    assert str(got.value).rsplit(",", 1)[0] == \
        str(want.value).rsplit(",", 1)[0]
    # Every axis is ported: pipe=2 needs its two devices like any other.
    for axis in ("pipe", "seq", "expert", "data"):
        with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
            sharding.build_mesh(sharding.MeshConfig(**{axis: 2}), "cpu")
    assert sharding.batch_shardings(None) is None
    assert sharding.dp_coordinate(None) == (0, 1)


JOBSET_ENV = {  # build_jobset's env for alice on v5p 2x2x2 (2 hosts)
    "TPUBC_COORDINATOR_ADDRESS": "alice-slice-workers-0-0.alice-slice:8080",
    "TPUBC_NUM_HOSTS": "2",
    "TPUBC_JOBSET_NAME": "alice-slice",
    "TPUBC_ACCELERATOR": "tpu-v5p-slice",
    "TPUBC_TOPOLOGY": "2x2x2",
}


@pytest.mark.parametrize("case", ["jobset", "absent", "index_only",
                                  "multislice"])
def test_bootstrap_from_env_matches_reference(case):
    env = {"jobset": {**JOBSET_ENV, "JOB_COMPLETION_INDEX": "1"},
           "absent": {},
           "index_only": {"JOB_COMPLETION_INDEX": "0"},
           "multislice": {**JOBSET_ENV, "TPUBC_NUM_SLICES": "3",
                          "TPUBC_SLICE_ID": "2",
                          "JOB_COMPLETION_INDEX": "1"}}[case]
    got = train.bootstrap_from_env(env)
    assert got == jtrain.bootstrap_from_env(env)
    if case == "jobset":
        assert got == {"coordinator_address":
                       "alice-slice-workers-0-0.alice-slice:8080",
                       "num_processes": 2, "process_id": 1}
    elif case == "multislice":  # slice-major: slice * hosts + host
        assert got["num_processes"] == 6 and got["process_id"] == 2 * 2 + 1
    else:
        assert got is None


def test_rendezvous_refuses_megascale():
    with pytest.raises(NotImplementedError,
                       match="TPUBC_COORDINATOR_ADDRESS"):
        train.rendezvous({"MEGASCALE_COORDINATOR_ADDRESS": "x:1"})
    assert train.rendezvous({}) is False
    assert train.rendezvous({"JOB_COMPLETION_INDEX": "0"}) is False


@pytest.mark.parametrize("count", [1, 2, 4, 8])
def test_host_rows_partition_matches_reference(count):
    rows = [data.host_rows(8, process_index=p, process_count=count)
            for p in range(count)]
    assert rows == [jdata.host_rows(8, process_index=p, process_count=count)
                    for p in range(count)]
    covered = [i for r in rows for i in range(*r.indices(8))]
    assert covered == list(range(8))
    assert data.host_rows(8) == slice(0, 8)  # no mesh: the whole batch


def test_host_rows_must_divide():
    with pytest.raises(ValueError) as want:
        jdata.host_rows(6, process_index=0, process_count=4)
    with pytest.raises(ValueError) as got:
        data.host_rows(6, process_index=0, process_count=4)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mesh,micro", [
    (dict(), 0), (dict(data=2, fsdp=2), 0), (dict(dcn=2, expert=2), 0),
    (dict(pipe=2, data=2), 0), (dict(pipe=2, data=2), 3),
    (dict(pipe=4, fsdp=2), 0)])
def test_global_batch_size_with_microbatches(mesh, micro):
    ours = train.TrainConfig(mesh=sharding.MeshConfig(**mesh),
                             num_microbatches=micro)
    ref = jtrain.TrainConfig(mesh=jsharding.MeshConfig(**mesh),
                             num_microbatches=micro)
    assert train.global_batch_size(ours) == jtrain.global_batch_size(ref)


@pytest.mark.parametrize("env", [{}, {"WORKLOAD_MICROBATCHES": "6"},
                                 {"WORKLOAD_SCHEDULE": "1f1b",
                                  "WORKLOAD_MICROBATCHES": "4"}])
def test_workload_pipeline_env_parse(monkeypatch, env):
    """worker_main fills num_microbatches and pipeline_schedule from the
    env as the reference's does (the loop itself is stubbed out)."""
    got = {}
    for mod, key in ((train, "port"), (jtrain, "ref")):
        monkeypatch.setattr(mod, "train_loop",
                            lambda cfg, steps, key=key, **kw: got.setdefault(
                                key, cfg) and [])
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("WORKLOAD_MESH", "")
    monkeypatch.setenv("WORKLOAD_STEPS", "1")
    train.worker_main()
    jtrain.worker_main()
    for field in ("num_microbatches", "pipeline_schedule"):
        assert getattr(got["port"], field) == getattr(got["ref"], field)
    assert got["port"].mesh == sharding.MeshConfig()  # a world of one
