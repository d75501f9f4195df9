"""The port's ctypes bridge (tpu_bootstrap_torch/nativelib.py) held to the
reference's (tpu_bootstrap/nativelib.py): every public NativeLib method
called with the same arguments through both, each over its own build of
native/ (the reference's native/build/, the port's build/native/), gives
equal results, and the same error inputs raise NativeError with the same
message in both. The stateful families (tracer, metrics, log rate limit,
statusz) run the same script on both libraries after a reset, their random
span ids and clocks masked. Then the port's build: out of tree, native/
left byte for byte as it was, and three processes building a fresh tree at
once (the port's flock) end with one working library."""

import base64
import hashlib
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_bootstrap import nativelib as jnative
from tpu_bootstrap_torch import nativelib as tnative

ROOT = Path(__file__).resolve().parent.parent

KOREAN_HEADER = (
    "타임스탬프,이름,소속,이메일 주소,SNUCSE ID,사용할 서버,"
    "TPU 칩 개수,GPU 개수,vCPU 개수,메모리 (GiB),스토리지 (GiB),MiG 개수,"
    "요청 사유,승인")


def _row(username="alice", tpu=4, cpu=8, authorized="o"):
    return (f"2024. 1. 1 오전 10:00:00,앨리스,CSE,a@snu.ac.kr,{username},"
            f"tpu-serv,{tpu},0,{cpu},32,100,0,research,{authorized}")


SHEET = "\n".join([KOREAN_HEADER, _row(), _row("bob", cpu="x"),
                   _row("carol", tpu=16, authorized="x")]) + "\n"


def _ub(name="Alice", spec=None, status=None, rv="7"):
    o = {"apiVersion": "tpu.bacchus.io/v1", "kind": "UserBootstrap",
         "metadata": {"name": name, "uid": "u-1", "resourceVersion": rv},
         "spec": spec or {}}
    if status is not None:
        o["status"] = status
    return o


TPU = {"tpu": {"accelerator": "tpu-v5p-slice", "topology": "2x2x2",
               "slices": 2, "chips": 8, "hosts": 2}}
SERVE = {"tpu": {"accelerator": "tpu-v5-lite-podslice", "topology": "2x2",
                 "command": ["python", "-m", "tpu_bootstrap_torch.workload.train"],
                 "env": {"WORKLOAD_MODE": "serve",
                         "WORKLOAD_SERVE_PORT": "9000"}}}
RB = {"rolebinding": {
    "role_ref": {"api_group": "rbac.authorization.k8s.io",
                 "kind": "ClusterRole", "name": "edit"},
    "subjects": [{"api_group": "rbac.authorization.k8s.io", "kind": "User",
                  "name": "oidc:alice"}]},
      "quota": {"hard": {"requests.google.com/tpu": "4"}}}
SYNCED = {"synchronized_with_sheet": True}
JOBSET = {"metadata": {"name": "alice-slice"},
          "status": {"replicatedJobsStatus": [{"name": "workers",
                                               "ready": 2}]}}
NODES = [{"metadata": {"name": "n0"},
          "status": {"allocatable": {"google.com/tpu": "4", "cpu": "96"}}},
         {"metadata": {"name": "n1"},
          "status": {"allocatable": {"google.com/tpu": 8}}},
         {"metadata": {"name": "n2"},
          "status": {"allocatable": {"google.com/tpu": "4Ki"}}}]


def _review(op="CREATE", user="oidc:alice", groups=("tpu",), spec=None):
    req = {"uid": "uid-1", "operation": op,
           "userInfo": {"username": user, "groups": list(groups)}}
    if op != "DELETE":
        req["object"] = {"apiVersion": "tpu.bacchus.io/v1",
                         "kind": "UserBootstrap",
                         "metadata": {"name": "alice"},
                         "spec": spec if spec is not None else {}}
    return req


def _adm(lib):
    return lib.default_admission_config()


# (method, arguments): a callable argument is called with the library
# first (a default config of the library under test).
CASES = [
    ("version", ()), ("crd_yaml", ()), ("crd", ()),
    ("to_yaml", ({"a": [1, "two", {"b": None}], "c": 1.5},)),
    ("default_topology", ("tpu-v5p-slice",)),
    ("default_topology", ("tpu-v9-nope",)),
    ("infer_header", ("TPU 칩 개수",)), ("infer_header", ("무엇",)),
    ("sha256_hex", ("tpu-bootstrap",)), ("base64_encode", ("héllo",)),
    ("base64_decode", ("aMOpbGxv",)),
    ("json_roundtrip", ('{"a": [1, 2.5, "x", null, true]}',)),
    ("json_roundtrip", ('{"a": ',)),
    ("json_patch", ({"a": {"b": 1}, "l": [1]},
                    [{"op": "add", "path": "/a/c", "value": 2},
                     {"op": "remove", "path": "/a/b"},
                     {"op": "add", "path": "/l/-", "value": 3}])),
    ("json_patch", ({"a": 1}, [{"op": "remove", "path": "/missing"}])),
    ("validate_topology", ("tpu-v5-lite-podslice", "2x2")),
    ("validate_topology", ("tpu-v5-lite-podslice", "3x3")),
    ("slice_geometry", ("tpu-v5p-slice", "4x4x4")),
    ("slice_geometry", ("tpu-v9-nope", "2x2")),
    ("classify_username", ("oidc:alice", "oidc:")),
    ("classify_username", ("system:admin", "oidc:")),
    ("default_admission_config", ()),
    ("mutate", (_review(spec=SERVE), _adm)),
    ("mutate", (_review(groups=("other",)), _adm)),
    ("mutate", (_review(spec={"tpu": {"accelerator": "tpu-v9-nope"}}),
                _adm)),
    ("mutate", (_review(op="DELETE"), _adm)),
    ("mutate_review", ({"apiVersion": "admission.k8s.io/v1",
                        "kind": "AdmissionReview",
                        "request": _review(spec=TPU)}, _adm)),
    ("default_controller_config", ()),
    ("desired_children", (_ub(spec={**RB, **SERVE}, status=SYNCED),)),
    ("desired_children", (_ub(spec=RB),)),
    ("desired_children", (_ub(spec={"tpu": {"accelerator": "nope"}}),)),
    ("build_jobset", (_ub(spec=TPU),)),
    ("build_jobset", (_ub(spec=SERVE),)),
    ("slice_status", (_ub(spec=TPU), JOBSET)),
    ("slice_status", (_ub(spec=TPU), None)),
    ("jobset_spec_changed", (_ub(spec=TPU, status={
        "slice": {"spec_hash": "stale", "jobset": "alice-slice"}}),
        {"metadata": {"labels": {"tpu.bacchus.io/spec-hash": "new"}}})),
    ("slice_event", (_ub(spec=TPU), "Pending",
                     {"phase": "Provisioning", "jobset": "alice-slice",
                      "chips": 8, "hosts": 2}, "2026-07-30T00:00:00Z")),
    ("slice_event", (_ub(spec=TPU), "Running", {"phase": "Running"}, "t")),
    ("refresh_event", (None, {"kind": "Event", "count": 1,
                              "firstTimestamp": "T0",
                              "lastTimestamp": "T0"})),
    ("refresh_event", ({"kind": "Event", "count": 1, "firstTimestamp": "T0",
                        "lastTimestamp": "T0"},
                       {"kind": "Event", "count": 1, "firstTimestamp": "T5",
                        "lastTimestamp": "T5"})),
    ("parse_sheet", (SHEET,)), ("parse_sheet", ("혈액형,이름\nA,x\n",)),
    ("default_synchronizer_config", ()),
    ("build_quota", ({"cpu_request": 8, "memory_request": 32,
                      "storage_request": 100, "tpu_request": 4,
                      "gpu_request": 0, "mig_request": 0}, "tpu")),
    ("build_quota", ({"cpu_request": 8, "memory_request": 32,
                      "storage_request": 100, "tpu_request": 0,
                      "gpu_request": 2, "mig_request": 1}, "gpu")),
    ("node_pool_capacity", (NODES,)), ("node_pool_capacity", (NODES, "gpu")),
    ("plan_sync", ([_ub("alice"), _ub("carol")],
                   lambda lib: lib.parse_sheet(SHEET)["rows"],
                   lambda lib: {**lib.default_synchronizer_config(),
                                "server_name": "tpu-serv"})),
    ("log_level_for", ("info,tpubc::controller=debug", "tpubc::controller")),
    ("log_level_for", ("warn", "tpubc::admission")),
    ("workload_summary", ({"workload_last_step": 7,
                           "workload_tokens_per_sec": 123.5,
                           "serve_qps": 0.25}, "2026-08-04T00:00:00Z")),
    ("workload_summary", ({"serve_tokens_per_sec": 9.0, "serve_qps": 1.0},
                          "t")),
    ("workload_summary", ({"unrelated": 1}, "t")),
]


def _masked(obj, keys=("span_id", "start_us", "dur_us", "ts", "dur", "pid",
                       "generated_at_ms")):
    """``obj`` with the values under ``keys`` (random ids, clocks, the
    process id) replaced, at any depth."""
    if isinstance(obj, dict):
        return {k: "*" if k in keys else _masked(v, keys)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_masked(v, keys) for v in obj]
    return obj


def _unpatched(obj):
    """``obj`` with every base64 JSONPatch decoded and the trace id that
    admission stamps (random) masked."""
    if isinstance(obj, (list, tuple)):
        return [_unpatched(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    out = {k: _unpatched(v) for k, v in obj.items()}
    if obj.get("patchType") == "JSONPatch":
        out["patch"] = json.loads(base64.b64decode(obj["patch"]))
        for op in out["patch"]:
            if op["path"] == "/metadata/annotations":
                op["value"] = {k: "*" for k in op["value"]}
    return out


def _outcome(lib, method, args):
    args = [a(lib) if callable(a) else json.loads(json.dumps(a))
            for a in args]
    try:
        return "ok", getattr(lib, method)(*args)
    except tnative.NativeError as e:
        return "NativeError", str(e)
    except jnative.NativeError as e:
        return "NativeError", str(e)


STATEFUL = {
    "trace": [("trace_test_span", ("controller.reconcile", "t-1", "")),
              ("trace_test_span", ("webhook.mutate", "t-2", "p-1")),
              ("trace_dump", ()), ("trace_chrome", ())],
    "metrics": [("metrics_inc", ("x_total", 3)),
                ("metrics_observe", ("lat_ms", 5.0)),
                ("metrics_observe", ("lat_ms", 70.0)),
                ("metrics_quantile", ("lat_ms", 0.5)),
                ("metrics_quantile", ("none_ms", 0.5)),
                ("metrics_json", ()), ("metrics_prometheus", ())],
    "log": [("log_ratelimit_allow", ("tpubc::controller", "flood", t))
            for t in range(0, 20_000, 1000)],
    "statusz": [("statusz_record", ("alice", {"ts_ms": 1000,
                                              "op": "reconcile",
                                              "duration_ms": 3.5,
                                              "trace_id": "t-1"})),
                ("statusz_record", ("bob", {"ts_ms": 2000, "op": "sync",
                                            "error": "boom"})),
                ("statusz_set_state", ("leader", True)),
                ("statusz", ()), ("statusz", ("alice",))],
}
RESETS = ("trace_reset", "metrics_reset", "log_ratelimit_reset",
          "statusz_reset")


@pytest.fixture(scope="module")
def libs(lib):
    """(the reference's library, the port's), over their own builds."""
    port = tnative.get()
    assert Path(port._lib._name).parent == tnative.BUILD_DIR
    assert Path(lib._lib._name).parent == jnative.BUILD_DIR
    return lib, port


def _public(cls) -> set:
    return {n for n, _ in inspect.getmembers(cls, inspect.isfunction)
            if not n.startswith("_")}


def test_every_public_method_is_named_here():
    covered = ({m for m, _ in CASES} | set(RESETS)
               | {m for seq in STATEFUL.values() for m, _ in seq})
    assert _public(tnative.NativeLib) == _public(jnative.NativeLib)
    assert _public(tnative.NativeLib) == covered
    for name in ("NativeError", "DAEMONS", "build_native", "get"):
        assert hasattr(tnative, name), name
    assert tnative.DAEMONS == jnative.DAEMONS


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(CASES)])
def test_method_agrees_with_reference(libs, case):
    method, args = CASES[case]
    ref, port = libs
    want, got = _outcome(ref, method, args), _outcome(port, method, args)
    assert _unpatched(got) == _unpatched(want)


def test_error_inputs_raise_native_error_in_both(libs):
    for lib in libs:
        cls = (tnative if lib is libs[1] else jnative).NativeError
        for method, args in (("default_topology", ("tpu-v9-nope",)),
                             ("json_roundtrip", ('{"a": ',)),
                             ("slice_geometry", ("tpu-v9-nope", "2x2"))):
            with pytest.raises(cls):
                getattr(lib, method)(*args)


@pytest.mark.parametrize("family", sorted(STATEFUL))
def test_stateful_family_agrees_with_reference(libs, family):
    outs = []
    for lib in libs:
        for name in RESETS:
            getattr(lib, name)()
        outs.append([_masked(_outcome(lib, m, a)) for m, a in
                     STATEFUL[family]])
        for name in RESETS:
            getattr(lib, name)()
    assert outs[1] == outs[0]


def test_two_builds_keep_their_own_state(libs):
    """The two libraries are separate copies: a counter bumped in the
    port's does not show in the reference's."""
    ref, port = libs
    for lib in libs:
        lib.metrics_reset()
    port.metrics_inc("only_port_total", 2)
    assert port.metrics_json().get("only_port_total") == 2
    assert "only_port_total" not in ref.metrics_json()
    port.metrics_reset()


def _tree_digest(root: Path, skip: Path) -> dict:
    """Path -> sha256 of every file under ``root`` outside ``skip``."""
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and skip not in p.parents}


BUILD_SCRIPT = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from tpu_bootstrap_torch import nativelib as n
n.BUILD_DIR = Path(sys.argv[1])
n.LIB_PATH = n.BUILD_DIR / "libtpubc_capi.so"
n.build_native()
print(n.NativeLib().version())
"""


@pytest.fixture(scope="module")
def fresh_build(tmp_path_factory):
    """Three processes calling the port's build_native() at once on a
    fresh build directory, native/ digested before and after."""
    before = _tree_digest(tnative.NATIVE_DIR, jnative.BUILD_DIR)
    build = tmp_path_factory.mktemp("native") / "build"
    script = BUILD_SCRIPT.format(root=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", script, str(build)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    after = _tree_digest(tnative.NATIVE_DIR, jnative.BUILD_DIR)
    return {"build": build, "outs": outs, "before": before, "after": after}


def test_port_builds_out_of_tree():
    assert tnative.BUILD_DIR == ROOT / "build" / "native"
    assert tnative.LIB_PATH == tnative.BUILD_DIR / "libtpubc_capi.so"
    assert tnative.NATIVE_DIR == ROOT / "native"
    assert jnative.BUILD_DIR not in (tnative.BUILD_DIR,
                                     *tnative.BUILD_DIR.parents)


def test_fresh_build_leaves_native_unchanged(fresh_build):
    assert fresh_build["before"], "native/ has no sources"
    assert fresh_build["after"] == fresh_build["before"]
    build = fresh_build["build"]
    assert (build / "libtpubc_capi.so").exists()
    for daemon in tnative.DAEMONS:
        assert (build / f"tpubc-{daemon}").exists(), daemon


def test_concurrent_builds_end_with_one_working_library(fresh_build, libs):
    versions = set()
    for out, err, code in fresh_build["outs"]:
        assert code == 0, err
        versions.add(out.strip().splitlines()[-1])
    assert versions == {libs[0].version()}
    build = fresh_build["build"]
    lib = tnative.NativeLib(path=build / "libtpubc_capi.so")
    assert lib.crd() == libs[0].crd()
    crd = subprocess.run([str(build / "tpubc-crdgen")], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    assert crd == libs[0].crd_yaml()


def _build_in(build: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", BUILD_SCRIPT.format(root=str(ROOT)),
         str(build)], capture_output=True, text=True, timeout=600)


def test_configured_build_is_kept(fresh_build):
    """A configuration made here is reused: a second build_native() is a
    no-op and leaves the library as it was."""
    lib = fresh_build["build"] / "libtpubc_capi.so"
    before = lib.stat().st_mtime_ns
    done = _build_in(fresh_build["build"])
    assert done.returncode == 0, done.stderr
    assert lib.stat().st_mtime_ns == before


def test_configuration_from_another_host_is_made_anew(tmp_path, libs):
    """A build directory configured elsewhere (its cache and build.ninja
    naming a cmake that is not here, build.ninja older than the sources,
    so ninja would regenerate with it) is cleared and configured again."""
    build = tmp_path / "build"
    build.mkdir()
    gone = tmp_path / "elsewhere" / "bin" / "cmake"
    (build / "CMakeCache.txt").write_text(
        f"CMAKE_COMMAND:INTERNAL={gone}\n"
        f"CMAKE_ROOT:INTERNAL={gone.parent.parent / 'share'}\n"
        f"CMAKE_HOME_DIRECTORY:INTERNAL={tnative.NATIVE_DIR}\n"
        f"CMAKE_CACHEFILE_DIR:INTERNAL={build}\n")
    ninja = build / "build.ninja"
    ninja.write_text(
        "rule RERUN_CMAKE\n"
        f"  command = {gone} --regenerate-during-build"
        f" -S{tnative.NATIVE_DIR} -B{build}\n"
        "  generator = 1\n"
        f"build build.ninja: RERUN_CMAKE {tnative.NATIVE_DIR}/CMakeLists.txt"
        "\ndefault build.ninja\n")
    os.utime(ninja, (0, 0))
    done = _build_in(build)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == libs[0].version()
    cache = (build / "CMakeCache.txt").read_text()
    assert str(gone) not in cache and str(gone) not in ninja.read_text()
    for daemon in tnative.DAEMONS:
        assert (build / f"tpubc-{daemon}").exists(), daemon
