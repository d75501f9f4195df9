"""The port's data pipeline, checkpoints, fault seam and env parsing
(tpu_bootstrap_torch/workload/{data,checkpoint,faults,train}.py) on the
CPU: token batches equal to the reference's byte for byte, a resumed
train_loop equal to an uninterrupted one, an injected ``ckpt.save`` fault
that leaves the previous checkpoint the latest, and the reference's
errors from parse_model_env / parse_mesh_env and the TPUBC_FAULT grammar."""

import os

import numpy as np
import pytest
import torch

from tpu_bootstrap.workload import data as jdata
from tpu_bootstrap.workload import faults as jfaults
from tpu_bootstrap.workload import train as jtrain
from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import checkpoint as tckpt
from tpu_bootstrap_torch.workload import data as tdata
from tpu_bootstrap_torch.workload import faults as tfaults
from tpu_bootstrap_torch.workload import model as tmodel
from tpu_bootstrap_torch.workload import train as ttrain

torch.set_num_threads(2)

MODEL = tmodel.ModelConfig(vocab_size=64, num_layers=1, num_heads=2,
                           head_dim=16, embed_dim=32, mlp_dim=48,
                           max_seq_len=9)
CFG = ttrain.TrainConfig(model=MODEL, learning_rate=1e-2, warmup_steps=1,
                         total_steps=6, grad_clip_norm=1.0,
                         attention="flash")


@pytest.fixture
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    tdata.write_token_file(path, np.random.default_rng(0).integers(
        0, 60000, 1000))
    return str(path)


def test_token_batches_equal_reference_byte_for_byte(token_file):
    want = jdata.TokenDataset(jdata.DataConfig(path=token_file, seed=3), 33)
    got = tdata.TokenDataset(tdata.DataConfig(path=token_file, seed=3), 33)
    assert got.num_windows == want.num_windows == 30
    for step in (0, 1, 7, 29):  # 7 and 29 wrap around the permutation
        a, b = got.batch(step, 4), want.batch(step, 4)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tdata.host_rows(4) == jdata.host_rows(4, 0, 1)
    rows = jdata.host_rows(4, 1, 2)  # a sub-slice of the global batch
    assert got.batch(5, 4, rows=rows).tobytes() == want.batch(
        5, 4, rows=rows).tobytes()
    batch = tdata.make_batch_fn(tdata.DataConfig(path=token_file, seed=3),
                                33, 4, "cpu")(2)
    assert batch.dtype == torch.int64
    assert batch.numpy().tobytes() == want.batch(2, 4).astype(
        np.int64).tobytes()
    steps = [s for s, _ in tdata.prefetched(lambda s: s * 10, 3, 7)]
    assert steps == [3, 4, 5, 6]
    with pytest.raises(ValueError, match="exceeds"):
        got.batch(0, 31)


def test_train_loop_resume_matches_uninterrupted(tmp_path):
    telemetry.metrics().reset()
    whole = ttrain.train_loop(CFG, 4, checkpoint_dir=str(tmp_path / "a"),
                              save_every=2, device="cpu")
    assert telemetry.metrics().to_json().get("workload_restarts_total") is None
    first = ttrain.train_loop(CFG, 2, checkpoint_dir=str(tmp_path / "b"),
                              save_every=2, device="cpu")
    rest = ttrain.train_loop(CFG, 4, checkpoint_dir=str(tmp_path / "b"),
                             save_every=2, device="cpu")
    assert len(whole) == 4 and first == whole[:2] and rest == whole[2:]
    gauges = telemetry.metrics().to_json()
    assert gauges["workload_restarts_total"] == 1
    assert gauges["workload_resumed_from_step"] == 2
    assert gauges["workload_last_step"] == 4
    assert gauges["workload_train_steps_total"] == 8
    assert gauges["workload_checkpoint_restore_ms_count"] == 1
    assert "workload_train_mfu" not in gauges  # no card, no MFU
    assert telemetry._beat["step"] == 4
    assert [s["step"] for s in telemetry.spans()
            if s["name"] == "train.step"][-2:] == [2, 3]
    # Done already: a third call runs nothing.
    assert ttrain.train_loop(CFG, 4, checkpoint_dir=str(tmp_path / "b"),
                             device="cpu") == []


def test_injected_save_fault_keeps_previous_checkpoint(tmp_path):
    tfaults.install("ckpt.save:1:1")  # the second save fails
    try:
        with pytest.raises(tfaults.InjectedFault, match="ckpt.save"):
            ttrain.train_loop(CFG, 4, checkpoint_dir=str(tmp_path),
                              save_every=2, device="cpu")
    finally:
        tfaults.install(None)
    mgr = tckpt.make_manager(str(tmp_path))
    assert tckpt.latest_step(mgr) == 2
    assert sorted(os.listdir(tmp_path)) == ["2"]
    params, opt_state = tckpt.restore(mgr, 2, device="cpu")
    assert opt_state["count"] == 2
    assert params["embed"].shape == (MODEL.vocab_size, MODEL.embed_dim)


def test_checkpoints_keep_the_newest_three(tmp_path):
    mgr = tckpt.make_manager(str(tmp_path))
    state = {"w": torch.arange(3.0)}
    for step in range(1, 6):
        tckpt.save(mgr, step, state, {"count": step})
    (tmp_path / "9").mkdir()  # an unfinished step without its state file
    assert tckpt.steps(mgr) == [3, 4, 5] and tckpt.latest_step(mgr) == 5
    params, opt = tckpt.restore(mgr, 4, device="cpu")
    assert torch.equal(params["w"], state["w"]) and opt == {"count": 4}


def test_train_loop_reads_a_token_file(tmp_path):
    path = str(tmp_path / "small.bin")
    tdata.write_token_file(path, np.random.default_rng(1).integers(
        0, MODEL.vocab_size, 200))
    cfg = ttrain.TrainConfig(model=MODEL,
                             data=tdata.DataConfig(path=path, seed=1))
    a = ttrain.train_loop(cfg, 3, device="cpu",
                          profile_dir=str(tmp_path / "prof"))
    b = ttrain.train_loop(cfg, 3, device="cpu")
    assert a == b and len(a) == 3 and all(np.isfinite(a))
    assert (tmp_path / "prof" / "trace.json").is_file()


@pytest.mark.parametrize("value", [
    "num_layers=0", "num_layerz=2", "embed_dim", "num_layers=2,num_layers=3",
    "compute_dtype=int8", "num_heads=4,num_kv_heads=3",
    "vocab_size=100,vocab_chunk=30", "moe_aux_coef=-1",
    "expert_capacity_factor=nan"])
def test_parse_model_env_errors_match_reference(value):
    with pytest.raises(ValueError) as want:
        jtrain.parse_model_env(value)
    with pytest.raises(ValueError) as got:
        ttrain.parse_model_env(value)
    assert str(got.value) == str(want.value)


def test_parse_model_env_values_match_reference():
    value = ("embed_dim=1024,num_layers=8,vocab_size=32768,vocab_chunk=4096,"
             "compute_dtype=bfloat16,num_kv_heads=none,max_seq_len=8192")
    got, want = ttrain.parse_model_env(value), jtrain.parse_model_env(value)
    assert got.compute_dtype == torch.bfloat16
    for f in ("embed_dim", "num_layers", "vocab_size", "vocab_chunk",
              "num_kv_heads", "max_seq_len", "num_heads"):
        assert getattr(got, f) == getattr(want, f)
    assert ttrain.parse_model_env("") == tmodel.ModelConfig()


@pytest.mark.parametrize("value,n", [("pipe=2,data=4", 4), ("data=0", 1),
                                     ("rows=2", 2), ("data=2,data=2", 4),
                                     ("tensor", 1)])
def test_parse_mesh_env_errors_match_reference(value, n):
    with pytest.raises(ValueError) as want:
        jtrain.parse_mesh_env(value, n)
    with pytest.raises(ValueError) as got:
        ttrain.parse_mesh_env(value, n)
    assert str(got.value) == str(want.value)
    for value, n in (("", 8), ("", 1), ("pipe=2,data=4", 8)):
        got, want = ttrain.parse_mesh_env(value, n), jtrain.parse_mesh_env(
            value, n)
        assert (got.dcn, got.pipe, got.data, got.fsdp, got.expert, got.seq,
                got.tensor) == (want.dcn, want.pipe, want.data, want.fsdp,
                                want.expert, want.seq, want.tensor)


def test_fault_schedules_match_reference():
    spec = "ckpt.save:1:2,ckpt.save:0.5:4:7,alloc"
    ours, theirs = tfaults.FaultInjector(spec), jfaults.FaultInjector(spec)
    for site in ["ckpt.save"] * 30 + ["alloc"] * 3:
        fired = []
        for inj, exc in ((ours, tfaults.InjectedFault),
                         (theirs, jfaults.InjectedFault)):
            try:
                inj.fire(site)
                fired.append(None)
            except exc as e:
                fired.append((e.site, e.count))
        assert fired[0] == fired[1]
    assert ours.stats() == theirs.stats()
    for bad in ("nowhere", "ckpt.save:2"):
        with pytest.raises(ValueError) as want:
            jfaults.FaultInjector(bad)
        with pytest.raises(ValueError) as got:
            tfaults.FaultInjector(bad)
        assert str(got.value) == str(want.value)


def test_worker_main_refuses_what_is_not_ported(monkeypatch):
    from tpu_bootstrap_torch.workload import serving as tserving

    monkeypatch.setenv("WORKLOAD_MODE", "serve")
    # WORKLOAD_MODE=serve reaches the serve entry.
    calls = []
    real_entry = tserving.serve_demo_from_env
    monkeypatch.setattr(tserving, "serve_demo_from_env",
                        lambda device=None: calls.append(device))
    ttrain.worker_main()
    assert calls == [None]
    monkeypatch.setattr(tserving, "serve_demo_from_env", real_entry)
    # Without a card the entry raises resolve_device's error and runs
    # nothing on the host.
    built = []
    monkeypatch.setattr(tmodel, "init_params",
                        lambda *a, **k: built.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.worker_main()
    assert built == []
    monkeypatch.undo()
    # The paged engine asks for the int8 KV pool: WORKLOAD_PAGED=1 alone
    # is the float pool, item 8 (the card mapped to the CPU here).
    monkeypatch.setenv("WORKLOAD_MODE", "serve")
    monkeypatch.setenv("WORKLOAD_MODEL", "vocab_size=32,num_layers=1,"
                       "num_heads=2,head_dim=16,embed_dim=16,mlp_dim=32,"
                       "max_seq_len=64")
    monkeypatch.setenv("WORKLOAD_QUANT", "int8")
    monkeypatch.setenv("WORKLOAD_PAGED", "1")
    monkeypatch.setattr(tserving, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="item 8"):
        ttrain.worker_main()
    monkeypatch.undo()
    monkeypatch.setenv("WORKLOAD_MODE", "train")
    monkeypatch.setenv("TPUBC_COORDINATOR_ADDRESS", "worker-0:1234")
    for hosts, slices in (("2", "1"), ("1", "2")):
        monkeypatch.setenv("TPUBC_NUM_HOSTS", hosts)
        monkeypatch.setenv("TPUBC_NUM_SLICES", slices)
        with pytest.raises(NotImplementedError, match="item 11"):
            ttrain.worker_main()
