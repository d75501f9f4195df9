"""The port's fake API server (tpu_bootstrap_torch/fakeapi.py) held to the
reference's (tpu_bootstrap/fakeapi.py): the same scripted HTTP sequences
against a FakeKube of each package give equal status codes and bodies,
with ``uid`` and ``creationTimestamp`` masked. Covered: POST, GET, LIST,
JSON-patch, merge-patch, server-side apply with two managers, a conflict
and a forced transfer, the JobSet immutability rejection, PUT with a stale
resourceVersion, the status subresource and the CRD schema (pruning,
rejection), DELETE, a watch from a resourceVersion, a 410 past the event
horizon, label selectors, and fault injection with the same fault_seed.
Then hypothesis cases on apply_json_patch, merge_patch, leaf_paths and
fields_v1 over random documents. Every server listens on 127.0.0.1:0 and
every call has a timeout."""

import copy
import json
import urllib.error
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_bootstrap import fakeapi as jfake
from tpu_bootstrap_torch import fakeapi as tfake

HTTP_S = 30
KEY_NS = ("api/v1", "", "namespaces")
UB = "/apis/tpu.bacchus.io/v1/userbootstraps"
CM = "/api/v1/namespaces/team/configmaps"
JS = "/apis/jobset.x-k8s.io/v1alpha2/namespaces/team/jobsets"


def _masked(obj):
    """``obj`` with uid and creationTimestamp values masked, at any
    depth."""
    if isinstance(obj, dict):
        return {k: "*" if k in ("uid", "creationTimestamp") else _masked(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def call(base, method, path, body=None, ctype="application/json",
         headers=None):
    """(status, masked JSON body) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": ctype,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_S) as r:
            return r.status, _masked(json.loads(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, _masked(json.loads(e.read()))


def watch(base, path, lines: int):
    """The first ``lines`` events of a watch stream (fewer when the server
    ends it), masked."""
    out = []
    with urllib.request.urlopen(base + path, timeout=HTTP_S) as r:
        for raw in r:
            if raw.strip():
                out.append(_masked(json.loads(raw)))
            if len(out) == lines:
                break
    return out


@pytest.fixture()
def pair(request):
    """A started FakeKube of each package, built with the same arguments
    (``request.param``, default none), the reference's first."""
    kw = getattr(request, "param", {})
    fakes = [jfake.FakeKube(**kw).start(), tfake.FakeKube(**kw).start()]
    yield fakes
    for f in fakes:
        f.stop()


def run_both(pair, script):
    """``script(fake)`` on each server; the port's answers, which must
    equal the reference's."""
    want, got = (script(f) for f in pair)
    assert got == want
    return got


def _ns(name, labels=None):
    meta = {"name": name}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": meta}


def _ub_obj(name, spec):
    return {"apiVersion": "tpu.bacchus.io/v1", "kind": "UserBootstrap",
            "metadata": {"name": name}, "spec": spec}


def test_public_names_match_the_reference():
    for name in ("Store", "FakeKubeHandler", "_TrackingHTTPServer",
                 "FakeKube", "FAKEAPI_VERSION", "apply_json_patch",
                 "merge_patch", "leaf_paths", "fields_v1", "get_path",
                 "set_path", "del_path", "main"):
        assert hasattr(tfake, name), name
    assert tfake.FAKEAPI_VERSION == jfake.FAKEAPI_VERSION == 3
    assert tfake.FakeKube.KEY_UB == jfake.FakeKube.KEY_UB


def test_crud_and_patches(pair):
    def script(f):
        u = f.url
        return [
            call(u, "POST", "/api/v1/namespaces", _ns("team")),
            call(u, "POST", "/api/v1/namespaces", _ns("team")),
            call(u, "POST", "/api/v1/namespaces", {"metadata": {}}),
            call(u, "GET", "/api/v1/namespaces/team"),
            call(u, "GET", "/api/v1/namespaces/nope"),
            call(u, "GET", "/api/v1/namespaces"),
            call(u, "PATCH", "/api/v1/namespaces/team",
                 [{"op": "add", "path": "/metadata/labels",
                   "value": {"a": "1"}}], "application/json-patch+json"),
            call(u, "PATCH", "/api/v1/namespaces/team",
                 {"metadata": {"labels": {"a": None, "b": "2"}}},
                 "application/merge-patch+json"),
            call(u, "PATCH", "/api/v1/namespaces/team",
                 [{"op": "remove", "path": "/spec/none"}],
                 "application/json-patch+json"),
            call(u, "PATCH", "/api/v1/namespaces/nope", {},
                 "application/merge-patch+json"),
            call(u, "PATCH", "/api/v1/namespaces/team", {}, "text/plain"),
            call(u, "PATCH", "/api/v1/namespaces", {},
                 "application/merge-patch+json"),
            call(u, "GET", "/nowhere"),
            call(u, "DELETE", "/api/v1/namespaces/team"),
            call(u, "DELETE", "/api/v1/namespaces/team"),
            (f.list_names(KEY_NS), _masked(f.get(KEY_NS, "team"))),
        ]

    run_both(pair, script)


def test_server_side_apply_managers_and_conflicts(pair):
    def apply(u, manager, data, force=False, path=CM + "/cfg", body=None):
        q = f"?fieldManager={manager}" + ("&force=true" if force else "")
        return call(u, "PATCH", path + q, body or {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "cfg", "namespace": "team"}, "data": data},
            "application/apply-patch+yaml")

    def jobset(replicas):
        return {"apiVersion": "jobset.x-k8s.io/v1alpha2", "kind": "JobSet",
                "metadata": {"name": "js", "namespace": "team"},
                "spec": {"replicatedJobs": [{"name": "w",
                                             "replicas": replicas}]}}

    def script(f):
        u = f.url
        return [
            apply(u, "alpha", {"x": "1", "y": "1"}),
            apply(u, "alpha", {"x": "1", "y": "1"}),  # no-op: rv kept
            apply(u, "beta", {"x": "2"}),  # conflict with alpha
            apply(u, "beta", {"z": "3"}),  # a field of its own
            apply(u, "beta", {"x": "2", "z": "3"}, force=True),
            apply(u, "alpha", {"y": "1"}),  # x stays: beta owns it now
            apply(u, "alpha", {}),  # declarative removal of y
            call(u, "GET", CM + "/cfg"),
            apply(u, "ctl", None, path=JS + "/js", body=jobset(1)),
            apply(u, "ctl", None, path=JS + "/js", body=jobset(2)),
            call(u, "GET", JS + "/js"),
        ]

    run_both(pair, script)


def test_status_put_rv_gate_and_schema(pair):
    def script(f):
        u = f.url
        out = [
            call(u, "POST", UB, _ub_obj("alice", {
                "tpu": {"accelerator": "tpu-v5-lite-podslice",
                        "topology": "2x2", "unknown_field": 1},
                "bogus": True})),
            call(u, "POST", UB, _ub_obj("bob", {
                "tpu": {"accelerator": "tpu-v9-nope"}})),
            call(u, "POST", UB, {"apiVersion": "tpu.bacchus.io/v1",
                                 "kind": "UserBootstrap",
                                 "metadata": {"name": "carol"}}),
            call(u, "PATCH", UB + "/alice/status",
                 {"status": {"synchronized_with_sheet": True}},
                 "application/merge-patch+json"),
            call(u, "PATCH", UB + "/alice/status",
                 {"status": {"synchronized_with_sheet": "yes"}},
                 "application/merge-patch+json"),
            call(u, "PATCH", UB + "/alice/status", {"status": {}},
                 "application/json-patch+json"),
            call(u, "PATCH", UB + "/nobody/status", {"status": {}},
                 "application/merge-patch+json"),
        ]
        cur = f.get(f.KEY_UB, "alice")
        rv = cur["metadata"]["resourceVersion"]
        stale = dict(cur, metadata=dict(cur["metadata"],
                                        resourceVersion="1"))
        fresh = dict(cur, status={"synchronized_with_sheet": False,
                                  "slice": {"phase": "Pending"}})
        out += [
            call(u, "PUT", UB + "/alice/status", stale),
            call(u, "PUT", UB + "/alice/status", fresh),
            call(u, "PUT", UB + "/alice/status", fresh),  # rv now stale
            call(u, "PUT", UB + "/nobody/status", fresh),
            call(u, "PUT", UB + "/alice", dict(
                fresh, metadata={"name": "alice"},
                spec={"kube_username": "alice"})),
            call(u, "GET", UB + "/alice"), rv,
            _masked(f.create_ub("dave", spec={"gpu": {"count": 1}},
                                status={"synchronized_with_sheet": True})),
            f.list_names(f.KEY_UB),
        ]
        return out

    run_both(pair, script)


def test_label_selectors(pair):
    def script(f):
        u = f.url
        for name, labels in (("a", {"app": "x", "tier": "web"}),
                             ("b", {"app": "y"}), ("c", None)):
            call(u, "POST", "/api/v1/namespaces", _ns(name, labels))
        out = []
        for sel in ("app=x", "app==y", "app!=x", "tier", "app=x,tier=web",
                    " app = x ", "app in (x)", "app notin (y)", "env in(x)",
                    ""):
            q = urllib.request.quote(sel)
            out.append(call(u, "GET", f"/api/v1/namespaces?labelSelector={q}"))
        return out

    run_both(pair, script)


def test_watch_from_a_resource_version(pair):
    def script(f):
        u = f.url
        codes = [call(u, "POST", CM, {"metadata": {"name": f"c{i}"},
                                      "data": {"i": str(i)}})[0]
                 for i in range(4)]
        call(u, "DELETE", CM + "/c1")
        call(u, "PATCH", CM + "/c2", {"data": {"i": "two"}},
             "application/merge-patch+json")
        since = f.get(("api/v1", "team", "configmaps"),
                      "c0")["metadata"]["resourceVersion"]
        return [codes,
                watch(u, f"{CM}?watch=1&resourceVersion={since}", 5),
                watch(u, "/api/v1/configmaps?watch=true", 4)]

    run_both(pair, script)


@pytest.mark.parametrize("pair", [{"event_horizon": 4}], indirect=True)
def test_watch_past_the_event_horizon_is_gone(pair):
    def script(f):
        u = f.url
        for i in range(80):  # past the horizon and its trimming slack
            call(u, "POST", "/api/v1/namespaces", _ns(f"n{i}"))
        return [watch(u, "/api/v1/namespaces?watch=1&resourceVersion=101",
                      5),
                f.store.compacted_through, len(f.store.events)]

    got = run_both(pair, script)
    assert got[0][0]["type"] == "ERROR"
    assert got[0][0]["object"]["code"] == 410


@pytest.mark.parametrize("pair", [{"error_rate": 0.5, "fault_seed": 7}],
                         indirect=True)
def test_fault_injection_follows_the_seed(pair):
    def script(f):
        u = f.url
        out = [call(u, "POST", "/api/v1/namespaces", _ns(f"n{i}"))[0]
               for i in range(24)]
        out.append(call(u, "GET", "/api/v1/namespaces")[0])  # reads clean
        out.append(f.list_names(KEY_NS))
        return out

    got = run_both(pair, script)
    assert 500 in got[:24] and 201 in got[:24]


# ---- the patch helpers on random documents ---------------------------------

KEYS = st.sampled_from(["a", "b", "c", "d~e", "f/g"])
SCALARS = (st.none() | st.booleans() | st.integers(-3, 3)
           | st.text("xyz", max_size=2))
DOCS = st.recursive(
    SCALARS, lambda inner: (st.lists(inner, max_size=3)
                            | st.dictionaries(KEYS, inner, max_size=3)),
    max_leaves=12)
OBJECTS = st.dictionaries(KEYS, DOCS, max_size=4)
TOKENS = st.sampled_from(["a", "b", "c", "d~0e", "f~1g", "0", "1", "2", "-"])
PATCH_OPS = st.lists(st.fixed_dictionaries(
    {"op": st.sampled_from(["add", "replace", "remove", "move"]),
     "path": st.lists(TOKENS, min_size=1, max_size=3).map(
         lambda ts: "/" + "/".join(ts)),
     "value": DOCS}), max_size=4)
HYPO = settings(max_examples=150, deadline=None, database=None,
                derandomize=True)


def _outcome(fn, *args):
    """("ok", the result, the arguments after the call) or the exception
    raised: the helpers mutate their arguments in place."""
    args = copy.deepcopy(args)
    try:
        return "ok", fn(*args), args
    except Exception as e:  # noqa: BLE001 - compared, not handled
        return type(e).__name__, str(e)


@HYPO
@given(doc=OBJECTS, patch=PATCH_OPS)
def test_apply_json_patch_matches_reference(doc, patch):
    assert (_outcome(tfake.apply_json_patch, doc, patch)
            == _outcome(jfake.apply_json_patch, doc, patch))


@HYPO
@given(target=DOCS, patch=DOCS)
def test_merge_patch_matches_reference(target, patch):
    assert (_outcome(tfake.merge_patch, target, patch)
            == _outcome(jfake.merge_patch, target, patch))


@HYPO
@given(doc=OBJECTS)
def test_leaf_paths_and_fields_v1_match_reference(doc):
    paths = tfake.leaf_paths(doc)
    assert paths == jfake.leaf_paths(doc)
    assert tfake.fields_v1(paths) == jfake.fields_v1(paths)
    for p in sorted(paths):
        assert tfake.get_path(doc, p) == jfake.get_path(doc, p)
