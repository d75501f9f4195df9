"""The controller's whole path with the port's harness, on the CPU: the
port's build of the native daemons (tpu_bootstrap_torch.nativelib, into
build/native/) against the port's fake API server, a port worker, and the
port's trace plane; each step held to the reference's where the reference
has one.

* The port-built controller writes the same children (Namespace,
  ResourceQuota, RoleBinding, JobSet, Service) for a serve-mode CR whose
  command is the port's entry against the port's FakeKube as against the
  reference's, ``uid``, ``creationTimestamp`` and ``resourceVersion``
  masked (the reference's tests/test_ingress.py:130-189).
* A port IngressServer configured from that JobSet's env answers streams
  equal to the reference's IngressServer on bridged weights and to solo
  ``generate``.
* The controller's scrape of that port server's /metrics.json lands in
  the CR's status.slice.workload (tests/test_workload_metrics.py:247-300).
* A traced run (bench.py:2600-2746): the admission daemon over TLS as the
  registered webhook and the controller, both writing TPUBC_TRACE_FILE,
  and the port's workload leg as a CPU subprocess under the propagated
  TPUBC_TRACE_ID and its own TPUBC_TRACE_FILE (written at exit), merged by
  the port's ``merge_chrome_traces`` into one timeline holding spans of all
  three processes under the trace id.

Every wait runs against tests/test_integration_daemons.py:wait_for's
deadlines; no fixed sleep."""

import base64
import json
import os
import signal
import ssl
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_integration_daemons import (
    Daemon,
    controller_env,
    free_port,
    wait_for,
)
from tests.test_torch_ingress import get, post, solo, tokens_of
from tests.test_torch_scheduler import JCFG, JPARAMS, TCFG, TPARAMS
from tpu_bootstrap import fakeapi as jfake
from tpu_bootstrap.workload import ingress as jingress
from tpu_bootstrap_torch import fakeapi as tfake
from tpu_bootstrap_torch import nativelib, telemetry
from tpu_bootstrap_torch.workload import ingress as tingress

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
NAME = "servee"
COMMAND = ["python", "-m", "tpu_bootstrap_torch.workload.train"]
SPEC = {"kube_username": NAME,
        "quota": {"hard": {"requests.google.com/tpu": "4"}},
        "rolebinding": {
            "role_ref": {"api_group": "rbac.authorization.k8s.io",
                         "kind": "ClusterRole", "name": "edit"},
            "subjects": [{"api_group": "rbac.authorization.k8s.io",
                          "kind": "User", "name": f"oidc:{NAME}"}]},
        "tpu": {"accelerator": "tpu-v5-lite-podslice", "topology": "2x2",
                "command": COMMAND,
                "env": {"WORKLOAD_MODE": "serve",
                        "WORKLOAD_SERVE_BATCH": "4"}}}
KEY_JS = ("apis/jobset.x-k8s.io/v1alpha2", NAME, "jobsets")
CHILDREN = {"namespaces": ("api/v1", "", "namespaces"),
            "resourcequotas": ("api/v1", NAME, "resourcequotas"),
            "rolebindings": ("apis/rbac.authorization.k8s.io/v1", NAME,
                             "rolebindings"),
            "jobsets": KEY_JS,
            "services": ("api/v1", NAME, "services")}
MASKED = ("uid", "creationTimestamp", "resourceVersion")
WAIT_S = 20.0


def _masked(obj):
    if isinstance(obj, dict):
        return {k: "*" if k in MASKED else _masked(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _controller(fake, **extra) -> Daemon:
    """The port's build of tpubc-controller against ``fake``."""
    nativelib.get()
    port = free_port()
    return Daemon(str(nativelib.BUILD_DIR / "tpubc-controller"),
                  controller_env(fake, port, tpubc_log="error", **extra),
                  port).wait_healthy()


def _children(fake) -> dict:
    """Every child the controller wrote for the CR, by collection."""
    out = {}
    for plural, key in CHILDREN.items():
        with fake.store.lock:
            coll = fake.store.collection(key)
            objs = [json.loads(json.dumps(coll[n])) for n in sorted(coll)]
        out[plural] = _masked(objs)
    return out


def _container(js) -> dict:
    return (js["spec"]["replicatedJobs"][0]["template"]["spec"]["template"]
            ["spec"]["containers"][0])


@pytest.fixture(scope="module")
def reconciled():
    """The children the port-built controller writes for the serve CR, on
    the reference's FakeKube and on the port's."""
    out = {}
    for pkg, fakeapi in (("ref", jfake), ("port", tfake)):
        fake = fakeapi.FakeKube().start()
        ctrl = _controller(fake)
        try:
            fake.create_ub(NAME, spec=SPEC,
                           status={"synchronized_with_sheet": True})
            for plural in CHILDREN:
                key = CHILDREN[plural]
                wait_for(lambda key=key: fake.list_names(key), WAIT_S,
                         desc=f"{pkg} {plural}")
            wait_for(lambda: (fake.get(fake.KEY_UB, NAME).get("status", {})
                              .get("slice", {}).get("jobset")), WAIT_S,
                     desc=f"{pkg} status.slice")
            out[pkg] = _children(fake)
        finally:
            code, err = ctrl.stop()
            fake.stop()
        assert code == 0, err
    return out


def test_controller_writes_the_same_children_on_both_fakes(reconciled):
    assert reconciled["port"] == reconciled["ref"]
    [js] = reconciled["port"]["jobsets"]
    container = _container(js)
    assert container["command"] == COMMAND
    env = {e["name"]: e.get("value") for e in container["env"]}
    [svc] = reconciled["port"]["services"]
    [svc_port] = svc["spec"]["ports"]
    assert svc_port["targetPort"] == int(env["WORKLOAD_SERVE_PORT"])
    assert {"containerPort": int(env["WORKLOAD_SERVE_PORT"]),
            "name": "serve"} in container["ports"]
    assert svc["spec"]["selector"]["jobset.sigs.k8s.io/jobset-name"] == \
        js["metadata"]["name"]


@pytest.fixture(scope="module")
def servers(reconciled):
    """The reference's and the port's IngressServer, configured from the
    reconciled JobSet's env (its batch; no WORKLOAD_PAGED: the replay-slot
    engine), on the f32 bridged int8 weights; the port's last."""
    env = {e["name"]: e.get("value")
           for e in _container(reconciled["port"]["jobsets"][0])["env"]}
    assert env["WORKLOAD_MODE"] == "serve" and "WORKLOAD_PAGED" not in env
    kw = dict(port=0, host="127.0.0.1",
              batch_size=int(env["WORKLOAD_SERVE_BATCH"]))
    out = [jingress.IngressServer(JPARAMS, JCFG, **kw).start(),
           tingress.IngressServer(TPARAMS, TCFG, device="cpu", **kw).start()]
    yield out
    for srv in out:
        srv.stop()


def test_ingress_from_the_jobset_env_matches_reference(servers):
    rng = np.random.default_rng(3)
    for _ in range(3):
        tokens = rng.integers(1, TCFG.vocab_size,
                              int(rng.integers(2, 9))).tolist()
        max_new = int(rng.integers(1, 9))
        answers = []
        for srv in servers:
            code, _, ans = post(srv.port, {"tokens": tokens,
                                           "max_new": max_new})
            assert code == 200
            answers.append(tokens_of(ans))
        assert answers[1] == answers[0]
        assert answers[1] == solo(tokens, max_new, kv_quant=False)


def test_controller_scrapes_the_port_replica_into_status(servers):
    port_srv = servers[1]
    code, _, _ = post(port_srv.port, {"tokens": [5, 6, 7], "max_new": 4})
    assert code == 200
    metrics = get(port_srv.port, "/metrics.json")[1]
    assert metrics["serve_tokens_per_sec"] > 0
    fake = tfake.FakeKube().start()
    ctrl = _controller(fake, conf_workload_scrape="1",
                       conf_workload_scrape_addr=f"127.0.0.1:{port_srv.port}",
                       conf_workload_scrape_interval_secs="1")
    try:
        fake.create_ub(NAME, spec=SPEC,
                       status={"synchronized_with_sheet": True})
        js = wait_for(lambda: fake.get(KEY_JS, f"{NAME}-slice"), WAIT_S,
                      desc="jobset")
        # The gang comes up (the JobSet controller's part): Running arms
        # the scrape.
        js["status"] = {"replicatedJobsStatus": [{"name": "workers",
                                                  "ready": 1}]}
        fake.store.upsert(KEY_JS, f"{NAME}-slice", js, preserve_status=False)

        def workload_block():
            ub = fake.get(fake.KEY_UB, NAME) or {}
            return ub.get("status", {}).get("slice", {}).get("workload")

        block = wait_for(workload_block, WAIT_S,
                         desc="status.slice.workload merged")
        assert block["tokens_per_sec"] > 0
        assert "serve_qps" in block and block["last_scrape"]
        assert ctrl.metrics()["workload_scrapes_total"] >= 1
    finally:
        code, err = ctrl.stop()
        fake.stop()
    assert code == 0, err


WORKLOAD_LEG = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from tpu_bootstrap_torch.workload import model, quant
from tpu_bootstrap_torch.workload.serving import Request, serve
cfg = model.ModelConfig(vocab_size=128, num_layers=2, num_heads=4,
                        head_dim=16, embed_dim=64, mlp_dim=128,
                        max_seq_len=64)
params = quant.quantize_params(model.init_params(cfg, seed=0, device="cpu"))
serve(params, cfg, [Request(rid=i, tokens=[1 + i, 2, 3], max_new=8)
                    for i in range(6)], 6, paged=True, kv_quant=True,
      block_size=4, device="cpu")
"""


def _tls_health(port: int, proc) -> bool:
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    assert proc.poll() is None, "tpubc-admission exited early"
    try:
        with urllib.request.urlopen(f"https://127.0.0.1:{port}/health",
                                    timeout=1, context=ctx) as r:
            return r.read() == b"pong"
    except OSError:
        return False


def _post_kube(fake, path, body, headers=None) -> int:
    req = urllib.request.Request(
        fake.url + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def test_traced_run_merges_three_processes(tmp_path):
    nativelib.get()
    traces = {k: tmp_path / f"{k}.json"
              for k in ("admission", "controller", "workload")}
    crt, key = tmp_path / "adm.crt", tmp_path / "adm.key"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", str(key), "-out", str(crt),
                    "-days", "1", "-subj", "/CN=trace-admission"],
                   check=True, capture_output=True, timeout=60)
    fake = tfake.FakeKube().start()
    aport = free_port()
    adm = subprocess.Popen(
        [str(nativelib.BUILD_DIR / "tpubc-admission")],
        env={**os.environ, "CONF_LISTEN_ADDR": "127.0.0.1",
             "CONF_LISTEN_PORT": str(aport), "CONF_CERT_PATH": str(crt),
             "CONF_KEY_PATH": str(key),
             "CONF_AUTHORIZED_GROUP_NAMES": "tpu,admin",
             "TPUBC_TRACE_FILE": str(traces["admission"]),
             "TPUBC_LOG": "error"},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    ctrl = None
    try:
        wait_for(lambda: _tls_health(aport, adm), WAIT_S,
                 desc="admission TLS health")
        ctrl = _controller(fake, tpubc_trace_file=str(traces["controller"]))
        assert _post_kube(
            fake, "/apis/admissionregistration.k8s.io/v1/"
            "mutatingwebhookconfigurations", {
                "apiVersion": "admissionregistration.k8s.io/v1",
                "kind": "MutatingWebhookConfiguration",
                "metadata": {"name": "tpubc-trace"},
                "webhooks": [{
                    "name": "mutate.tpu.bacchus.io",
                    "clientConfig": {
                        "url": f"https://127.0.0.1:{aport}/mutate",
                        "caBundle": base64.b64encode(
                            crt.read_bytes()).decode()},
                    "rules": [{"apiGroups": ["tpu.bacchus.io"],
                               "apiVersions": ["v1"],
                               "resources": ["userbootstraps"],
                               "operations": ["CREATE", "UPDATE",
                                              "DELETE"]}],
                    "failurePolicy": "Fail", "timeoutSeconds": 10}]}) == 201
        spec = {"tpu": dict(SPEC["tpu"])}
        assert _post_kube(
            fake, "/apis/tpu.bacchus.io/v1/userbootstraps",
            {"apiVersion": "tpu.bacchus.io/v1", "kind": "UserBootstrap",
             "metadata": {"name": NAME}, "spec": spec},
            {"Impersonate-User": f"oidc:{NAME}",
             "Impersonate-Group": "tpu"}) == 201
        req = urllib.request.Request(
            fake.url + f"/apis/tpu.bacchus.io/v1/userbootstraps/{NAME}"
            "/status", method="PATCH",
            data=json.dumps({"status": {"synchronized_with_sheet": True}})
            .encode(), headers={"Content-Type":
                                "application/merge-patch+json"})
        urllib.request.urlopen(req, timeout=30).close()
        js = wait_for(lambda: fake.get(KEY_JS, f"{NAME}-slice"), WAIT_S,
                      desc="the traced CR's JobSet")
        trace_id = js["metadata"]["annotations"][telemetry.TRACE_ANNOTATION]
        env = {e["name"]: e.get("value") for e in _container(js)["env"]}
        assert trace_id and env["TPUBC_TRACE_ID"] == trace_id
        leg = subprocess.run(
            [sys.executable, "-c", WORKLOAD_LEG.format(root=str(ROOT))],
            env={**os.environ, "TPUBC_TRACE_ID": env["TPUBC_TRACE_ID"],
                 "TPUBC_TRACE_FILE": str(traces["workload"])},
            capture_output=True, text=True, timeout=300)
        assert leg.returncode == 0, leg.stderr[-2000:]
    finally:
        codes = []
        adm.send_signal(signal.SIGTERM)
        try:
            codes.append(adm.wait(timeout=10))
        except subprocess.TimeoutExpired:
            adm.kill()
            adm.wait()
        if ctrl is not None:
            codes.append(ctrl.stop()[0])
        fake.stop()
    assert codes == [0, 0]
    merged = telemetry.merge_chrome_traces(str(tmp_path / "merged.json"),
                                           [str(p) for p in traces.values()])
    events = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    procs = {e["cat"] for e in events}
    in_trace = {e["cat"] for e in events
                if e.get("args", {}).get("trace_id") == trace_id}
    assert procs == in_trace == {"tpubc-admission", "tpubc-controller",
                                 "tpu-bootstrap-workload"}
    assert not [e for e in events if e["ts"] <= 0 or e["dur"] < 0]
