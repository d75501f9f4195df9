"""The port's write-path admission (tpu_bootstrap_torch/fakeadmission.py)
held to the reference's (tpu_bootstrap/fakeadmission.py).

* ``validate_crd_object`` against the chart's crd.yaml gives the same
  errors and the same pruned and defaulted object in both packages, on
  valid objects, enum and type violations, unknown fields, int-or-string
  values, nulls, a missing required field and a minimum.
* ``dispatch`` against the native admission daemon over TLS (the
  reference's build under its package, the port's build under the port),
  and against a dead URL under ``Fail`` and under ``Ignore``, gives the
  same outcome in both packages, the random trace id admission stamps
  masked; so does a UserBootstrap written through each package's FakeKube
  with the webhook registered.
"""

import base64
import copy
import json
import os
import signal
import socket
import ssl
import subprocess
import time
import urllib.request

import pytest

from tpu_bootstrap import fakeadmission as jadm
from tpu_bootstrap import fakeapi as jfake
from tpu_bootstrap import nativelib as jnative
from tpu_bootstrap_torch import fakeadmission as tadm
from tpu_bootstrap_torch import fakeapi as tfake
from tpu_bootstrap_torch import nativelib as tnative

TRACE_ANNOTATION = "tpu.bacchus.io/trace-id"
KEY_UB = tfake.FakeKube.KEY_UB
UP_S = 10.0  # a daemon's /health


def _ub(spec=None, status=None, **extra):
    obj = {"apiVersion": "tpu.bacchus.io/v1", "kind": "UserBootstrap",
           "metadata": {"name": "alice"}, **extra}
    if spec is not None:
        obj["spec"] = spec
    if status is not None:
        obj["status"] = status
    return obj


OBJECTS = {
    "valid": _ub({"tpu": {"accelerator": "tpu-v5p-slice",
                          "topology": "2x2x2", "slices": 2,
                          "command": ["python", "-m", "x"],
                          "env": {"WORKLOAD_MODE": "serve"}},
                  "quota": {"hard": {"cpu": 8, "memory": "32Gi"}}},
                 {"synchronized_with_sheet": True,
                  "slice": {"phase": "Running", "chips": 8,
                            "workload": {"tokens_per_sec": 1.5,
                                         "serve_qps": 0}}}),
    "enum": _ub({"tpu": {"accelerator": "tpu-v9-nope"}}),
    "types": _ub({"tpu": {"accelerator": "tpu-v5p-slice", "slices": "2",
                          "command": "python", "chips": True,
                          "env": {"A": 1}},
                  "kube_username": 7},
                 {"synchronized_with_sheet": "yes",
                  "slice": {"workload": {"tokens_per_sec": "fast"}}}),
    "unknown_fields": _ub({"tpu": {"accelerator": "tpu-v5p-slice",
                                   "mystery": {"x": 1}},
                           "extra": [1, 2]}, None, junk=True),
    "int_or_string": _ub({"quota": {"hard": {"a": 1, "b": "2", "c": 1.5,
                                             "d": False, "e": None}}}),
    "nulls": _ub({"tpu": None, "kube_username": None,
                  "rolebinding": {"role_ref": None}}),
    "missing_required": _ub(None, None),
    "minimum": _ub({"tpu": {"accelerator": "tpu-v5p-slice",
                            "ttl_seconds_after_finished": 10}}),
    "required_nested": _ub({"rolebinding": {"subjects": [{"kind": "User"}]},
                            "role": {"rules": [{"apiGroups": [""]}]}}),
    "not_an_object": _ub("spec-as-string"),
}


def test_public_names_match_the_reference():
    for name in ("load_crd_schema", "validate_crd_object",
                 "matching_webhooks", "dispatch", "_webhook_ssl_context",
                 "KEY_WEBHOOKS", "CRD_YAML"):
        assert hasattr(tadm, name), name
    assert tadm.KEY_WEBHOOKS == jadm.KEY_WEBHOOKS
    assert tadm.CRD_YAML == jadm.CRD_YAML


def test_the_schema_is_the_charts():
    schema = tadm.load_crd_schema()
    assert schema is not None and schema == jadm.load_crd_schema()
    assert "spec" in schema["properties"]


@pytest.mark.parametrize("case", sorted(OBJECTS))
def test_validate_crd_object_matches_reference(case):
    got, want = (copy.deepcopy(OBJECTS[case]) for _ in range(2))
    errors = tadm.validate_crd_object(got, tadm.load_crd_schema())
    assert errors == jadm.validate_crd_object(want, jadm.load_crd_schema())
    assert got == want  # pruned and defaulted alike
    if case == "valid":
        assert errors == []
    elif case not in ("unknown_fields", "int_or_string"):
        assert errors


def test_pruning_and_defaulting():
    obj = copy.deepcopy(OBJECTS["unknown_fields"])
    assert tadm.validate_crd_object(obj, tadm.load_crd_schema()) == []
    assert "extra" not in obj["spec"]
    assert "mystery" not in obj["spec"]["tpu"]
    assert "junk" not in obj  # pruned at the root too
    assert obj["metadata"] == {"name": "alice"}  # implicitly preserved
    obj = _ub({}, {})
    tadm.validate_crd_object(obj, tadm.load_crd_schema())
    assert obj["status"] == {"synchronized_with_sheet": False}


# ---- dispatch against the native admission daemon --------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cert(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    crt, key = d / "adm.crt", d / "adm.key"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-nodes", "-keyout", str(key), "-out", str(crt),
                    "-days", "1", "-subj", "/CN=fake-admission"],
                   check=True, capture_output=True, timeout=60)
    return crt, key


def _start_admission(build_dir, cert) -> tuple:
    """tpubc-admission of ``build_dir`` over TLS; (process, port) once
    its /health answers."""
    port = _free_port()
    proc = subprocess.Popen(
        [str(build_dir / "tpubc-admission")],
        env={**os.environ, "CONF_LISTEN_ADDR": "127.0.0.1",
             "CONF_LISTEN_PORT": str(port), "CONF_CERT_PATH": str(cert[0]),
             "CONF_KEY_PATH": str(cert[1]),
             "CONF_AUTHORIZED_GROUP_NAMES": "tpu,admin", "TPUBC_LOG": "error"},
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    deadline = time.time() + UP_S
    while time.time() < deadline:
        assert proc.poll() is None, "tpubc-admission exited early"
        try:
            with urllib.request.urlopen(f"https://127.0.0.1:{port}/health",
                                        timeout=1, context=ctx) as r:
                if r.read() == b"pong":
                    return proc, port
        except OSError:
            time.sleep(0.05)
    proc.kill()
    raise TimeoutError("tpubc-admission never became healthy")


@pytest.fixture(scope="module")
def daemons(lib, cert):
    """{package: admission port}: the reference's daemon from its own
    build (``lib`` builds native/build), the port's from build/native."""
    tnative.get()
    procs, ports = [], {}
    try:
        for pkg, build in (("ref", jnative.BUILD_DIR),
                           ("port", tnative.BUILD_DIR)):
            proc, port = _start_admission(build, cert)
            procs.append(proc)
            ports[pkg] = port
        yield ports
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()


def _config(url, cert, policy="Fail", ops=("CREATE", "UPDATE", "DELETE")):
    return {"apiVersion": "admissionregistration.k8s.io/v1",
            "kind": "MutatingWebhookConfiguration",
            "metadata": {"name": "tpubc"},
            "webhooks": [{
                "name": "mutate.tpu.bacchus.io",
                "clientConfig": {"url": url, "caBundle": base64.b64encode(
                    cert[0].read_bytes()).decode()},
                "rules": [{"apiGroups": ["tpu.bacchus.io"],
                           "apiVersions": ["v1"],
                           "resources": ["userbootstraps"],
                           "operations": list(ops)}],
                "failurePolicy": policy, "timeoutSeconds": 5}]}


def _masked(outcome):
    """A dispatch outcome with admission's random trace id masked."""
    obj, err = copy.deepcopy(outcome)
    notes = ((obj or {}).get("metadata") or {}).get("annotations") or {}
    if TRACE_ANNOTATION in notes:
        assert notes[TRACE_ANNOTATION]
        notes[TRACE_ANNOTATION] = "*"
    return obj, err


ALICE = {"username": "oidc:alice", "groups": ["tpu"]}
SPEC = {"tpu": {"accelerator": "tpu-v5-lite-podslice", "topology": "2x2"}}
DISPATCHES = {
    "create": ("CREATE", ALICE, _ub(SPEC), None),
    "create_denied": ("CREATE", {"username": "oidc:alice",
                                 "groups": ["other"]}, _ub(SPEC), None),
    "create_bad_topology": ("CREATE", ALICE,
                            _ub({"tpu": {"accelerator": "tpu-v5p-slice",
                                         "topology": "3x3"}}), None),
    "update": ("UPDATE", ALICE, _ub(dict(SPEC, kube_username="alice")),
               _ub(SPEC)),
    "delete": ("DELETE", ALICE, None, _ub(SPEC)),
}


def _dispatch(adm, fake, config, case):
    store = fake.Store()
    store.upsert(adm.KEY_WEBHOOKS, "tpubc", config)
    op, user, obj, old = DISPATCHES[case]
    return _masked(adm.dispatch(store, KEY_UB, op, "alice",
                                copy.deepcopy(obj), copy.deepcopy(old),
                                user))


@pytest.mark.parametrize("case", sorted(DISPATCHES))
def test_dispatch_over_tls_matches_reference(daemons, cert, case):
    want, got = (_dispatch(adm, fake, _config(
        f"https://127.0.0.1:{daemons[pkg]}/mutate", cert), case)
        for pkg, adm, fake in (("ref", jadm, jfake), ("port", tadm, tfake)))
    assert got == want
    if case == "create":
        obj, err = got
        assert err is None and obj["spec"]["kube_username"] == "alice"
        assert obj["metadata"]["annotations"][TRACE_ANNOTATION] == "*"
    if case == "create_denied":
        assert got[0] is None and got[1][0] == 403


@pytest.mark.parametrize("policy", ["Fail", "Ignore"])
def test_dead_webhook_follows_failure_policy(cert, policy):
    dead = f"https://127.0.0.1:{_free_port()}/mutate"
    want, got = (_dispatch(adm, fake, _config(dead, cert, policy), "create")
                 for adm, fake in ((jadm, jfake), (tadm, tfake)))
    assert got == want
    if policy == "Fail":
        assert got[0] is None and got[1][0] == 500
        assert "mutate.tpu.bacchus.io" in got[1][1]
    else:
        assert got == (DISPATCHES["create"][2], None)


def test_matching_webhooks_by_rule(cert):
    config = _config("https://127.0.0.1:1/mutate", cert, ops=("CREATE",))
    for adm, fake in ((jadm, jfake), (tadm, tfake)):
        store = fake.Store()
        store.upsert(adm.KEY_WEBHOOKS, "tpubc", config)
        assert len(adm.matching_webhooks(store, KEY_UB, "CREATE")) == 1
        assert adm.matching_webhooks(store, KEY_UB, "UPDATE") == []
        assert adm.matching_webhooks(
            store, ("api/v1", "", "namespaces"), "CREATE") == []
        assert adm._webhook_ssl_context({}) is None
        assert adm._webhook_ssl_context(
            config["webhooks"][0]) is not None


def test_write_path_through_each_fake(daemons, cert):
    """A UserBootstrap POSTed as an impersonated user through each
    package's FakeKube (the webhook registered there): the same answer
    and the same stored object, the admission patch applied."""
    results = []
    for pkg, fake in (("ref", jfake), ("port", tfake)):
        kube = fake.FakeKube().start()
        try:
            out = []
            for path, body, headers in (
                    ("/apis/admissionregistration.k8s.io/v1/"
                     "mutatingwebhookconfigurations", _config(
                         f"https://127.0.0.1:{daemons[pkg]}/mutate", cert),
                     {}),
                    ("/apis/tpu.bacchus.io/v1/userbootstraps", _ub(SPEC),
                     {"Impersonate-User": "oidc:alice",
                      "Impersonate-Group": "tpu"}),
                    ("/apis/tpu.bacchus.io/v1/userbootstraps",
                     dict(_ub(SPEC), metadata={"name": "bob"}),
                     {"Impersonate-User": "oidc:bob",
                      "Impersonate-Group": "nobody"})):
                req = urllib.request.Request(
                    kube.url + path, data=json.dumps(body).encode(),
                    method="POST", headers={
                        "Content-Type": "application/json", **headers})
                try:
                    with urllib.request.urlopen(req, timeout=30) as r:
                        out.append(r.status)
                except urllib.error.HTTPError as e:
                    out.append((e.code, json.loads(e.read())["message"]))
            stored = kube.get(KEY_UB, "alice")
            for k in ("uid", "creationTimestamp"):
                stored["metadata"].pop(k)
            out.append(_masked((stored, None))[0])
            out.append(kube.list_names(KEY_UB))
            results.append(out)
        finally:
            kube.stop()
    assert results[1] == results[0]
    assert results[1][1] == 201 and results[1][2][0] == 403
    assert results[1][3]["spec"]["kube_username"] == "alice"
