"""A fake Kubernetes API server for the port's integration tests and smoke
run: a copy of ``tpu_bootstrap.fakeapi`` (the port imports nothing of the
JAX package), with write-path admission through the port's
``fakeadmission``.

Implements the subset of the API machinery the daemons use — LIST, GET,
WATCH (chunked JSON-line streams), server-side-apply PATCH, RFC-6902 PATCH,
merge-PATCH and resourceVersion-checked PUT on the status subresource,
POST, DELETE — with a monotonically increasing resourceVersion and a
watch-event log, so the C++ controller/synchronizer run against it exactly
as they would against a real API server.

    python -m tpu_bootstrap_torch.fakeapi --port 8001
"""

from __future__ import annotations

import argparse
import copy
import random
import json
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

# Cost-profile version of this fake, the reference's: reconciles/s
# numbers are only compared between fakes of one version. Bump whenever
# per-request work changes materially.
FAKEAPI_VERSION = 3  # 3: write-path admission (webhook dispatch + CRD schema validation)


def apply_json_patch(doc, patch):
    """Minimal RFC 6902 (add/replace/remove only — what the daemons emit)."""

    def tokens(path):
        return [t.replace("~1", "/").replace("~0", "~") for t in path.split("/")[1:]]

    for op in patch:
        toks = tokens(op["path"])
        parent = doc
        for t in toks[:-1]:
            parent = parent[int(t)] if isinstance(parent, list) else parent[t]
        last = toks[-1]
        kind = op["op"]
        if kind in ("add", "replace"):
            if isinstance(parent, list):
                if last == "-":
                    parent.append(op["value"])
                elif kind == "add":
                    parent.insert(int(last), op["value"])
                else:
                    parent[int(last)] = op["value"]
            else:
                parent[last] = op["value"]
        elif kind == "remove":
            if isinstance(parent, list):
                parent.pop(int(last))
            else:
                del parent[last]
        else:
            raise ValueError(f"unsupported patch op {kind}")
    return doc


def merge_patch(target, patch):
    """RFC 7386 merge patch."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    if not isinstance(target, dict):
        target = {}
    for k, v in patch.items():
        if v is None:
            target.pop(k, None)
        else:
            target[k] = merge_patch(target.get(k), v)
    return target


# ---- server-side apply (managed fields) ------------------------------------

_MISSING = object()

# Identity/server-owned paths: never part of an apply's managed field set.
_UNMANAGED = {
    ("apiVersion",),
    ("kind",),
    ("metadata", "name"),
    ("metadata", "namespace"),
    ("metadata", "resourceVersion"),
    ("metadata", "uid"),
    ("metadata", "creationTimestamp"),
    ("metadata", "managedFields"),
}


def leaf_paths(obj, prefix=()):
    """Leaf field paths of a dict tree. Lists are atomic leaves — the
    daemons' objects use replace-semantics lists (ownerReferences, ports,
    subjects), matching k8s' atomic list strategy for untyped CRs."""
    paths = set()
    for k, v in obj.items():
        p = prefix + (k,)
        if isinstance(v, dict) and v:
            paths |= leaf_paths(v, p)
        else:
            paths.add(p)
    return paths


def get_path(obj, path):
    node = obj
    for seg in path:
        if not isinstance(node, dict) or seg not in node:
            return _MISSING
        node = node[seg]
    return node


def set_path(obj, path, value):
    node = obj
    for seg in path[:-1]:
        node = node.setdefault(seg, {})
    node[path[-1]] = value


def del_path(obj, path):
    parents = []
    node = obj
    for seg in path[:-1]:
        if not isinstance(node, dict) or seg not in node:
            return
        parents.append((node, seg))
        node = node[seg]
    if isinstance(node, dict):
        node.pop(path[-1], None)
    for parent, seg in reversed(parents):  # prune now-empty containers
        if parent[seg] == {}:
            del parent[seg]


def fields_v1(paths):
    """Render an owned path set in (simplified) fieldsV1 shape."""
    root = {}
    for p in sorted(paths):
        node = root
        for seg in p:
            node = node.setdefault(f"f:{seg}", {})
    return root


class Store:
    """Object store keyed by (api_prefix, namespace, plural) -> name -> obj."""

    def __init__(self, event_horizon: int = 100_000):
        self.lock = threading.Condition()
        self.objects: dict[tuple, dict[str, dict]] = {}
        self.rv = 100
        self.events: list[tuple[int, tuple, str, dict]] = []  # (rv, coll_key, type, obj)
        self.request_log: list[tuple[str, str]] = []
        # (coll_key, name) -> field manager -> owned leaf-path set (SSA).
        self.ownership: dict[tuple, dict[str, set]] = {}
        # Bounded watch history, like a real apiserver/etcd: events older
        # than the horizon are compacted away and a watch asking for a
        # resourceVersion before the compaction floor gets 410 Gone.
        self.event_horizon = event_horizon
        self.compacted_through = 0  # rv of the newest discarded event

    def next_rv(self):
        self.rv += 1
        return self.rv

    def collection(self, key):
        return self.objects.setdefault(key, {})

    def record_event(self, key, etype, obj):
        self.events.append((int(obj["metadata"]["resourceVersion"]), key, etype, obj))
        # Trim with slack so the O(horizon) memmove happens once per
        # slack-many events, not per event — all under the same store.lock
        # every request contends on.
        slack = max(self.event_horizon // 10, 64)
        if len(self.events) > self.event_horizon + slack:
            drop = len(self.events) - self.event_horizon
            self.compacted_through = max(self.compacted_through, self.events[drop - 1][0])
            del self.events[:drop]
        self.lock.notify_all()

    def upsert(self, key, name, obj, *, preserve_status=True, assume_fresh=False):
        """assume_fresh=True: the caller hands over ownership of a
        newly-built dict (no external references), so the defensive input
        copy is skipped — the SSA path builds fresh objects and was
        paying a double deepcopy per apply. Either way the stored object
        is immutable once recorded (watch history shares references)."""
        with self.lock:
            coll = self.collection(key)
            existing = coll.get(name)
            if not assume_fresh:
                obj = copy.deepcopy(obj)
            meta = obj.setdefault("metadata", {})
            meta["name"] = name
            if existing:
                meta.setdefault("uid", existing["metadata"]["uid"])
                meta["creationTimestamp"] = existing["metadata"]["creationTimestamp"]
                if preserve_status and "status" in existing and "status" not in obj:
                    obj["status"] = existing["status"]
                # metadata.generation: real apiservers bump it only when
                # SPEC changes (status/metadata-only writes keep it) —
                # the observedGeneration idiom controllers key off.
                prev_gen = existing["metadata"].get("generation", 1)
                meta["generation"] = (
                    prev_gen + 1
                    if obj.get("spec") != existing.get("spec") else prev_gen)
                etype = "MODIFIED"
            else:
                meta.setdefault("uid", str(uuid.uuid4()))
                meta["creationTimestamp"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                meta["generation"] = 1
                etype = "ADDED"
            meta["resourceVersion"] = str(self.next_rv())
            coll[name] = obj
            self.record_event(key, etype, obj)
            # Reference, not a copy: stored objects are immutable by
            # contract; handlers serialize the return value immediately.
            return obj

    def delete(self, key, name):
        with self.lock:
            coll = self.collection(key)
            obj = coll.pop(name, None)
            if obj is None:
                return None
            self.ownership.pop((key, name), None)
            # Copy before bumping rv: the popped object is still referenced
            # by earlier watch-history events, which must stay immutable.
            obj = copy.deepcopy(obj)
            obj["metadata"]["resourceVersion"] = str(self.next_rv())
            self.record_event(key, "DELETED", obj)
            return obj

    def server_side_apply(self, key, name, body, manager, force, *,
                          dry_run=False, final_obj=None):
        """Real(istic) SSA: per-manager field ownership, conflict
        detection, forced transfer, and declarative removal of fields the
        manager stopped applying. Returns (status_code, payload).

        Differences an apply-everything fake hides and this surfaces:
        a second manager applying a different value for an owned field
        gets 409 unless force=true; re-applying identical intent is a
        no-op (no resourceVersion bump, no watch event) — both exactly
        what a real apiserver does with the daemons' .force() semantics.

        dry_run=True computes and returns the would-be object without
        touching ownership or persisting — the handler's write-path
        admission phase (the webhook HTTP round trip must not run under
        the store lock). final_obj, when given, is the ADMITTED object
        (webhook mutations + schema defaults applied to the dry-run
        candidate) and persists in place of the recomputed merge;
        ownership still derives from the manager's applied field set.
        """
        with self.lock:
            existing = self.collection(key).get(name)
            owners = self.ownership.setdefault((key, name), {})
            applied_paths = {p for p in leaf_paths(body) if p not in _UNMANAGED}

            conflicts = {}  # other manager -> paths
            if existing is not None:
                for p in applied_paths:
                    current = get_path(existing, p)
                    wanted = get_path(body, p)
                    if current is not _MISSING and current != wanted:
                        for other, owned in owners.items():
                            if other != manager and p in owned:
                                conflicts.setdefault(other, set()).add(p)
            if conflicts and not force:
                detail = "; ".join(
                    f'conflict with "{m}": {".".join(map(str, sorted(ps)[0]))}'
                    + (f" (+{len(ps) - 1} more)" if len(ps) > 1 else "")
                    for m, ps in sorted(conflicts.items())
                )
                return 409, {
                    "kind": "Status",
                    "apiVersion": "v1",
                    "status": "Failure",
                    "message": f"Apply failed with {sum(len(p) for p in conflicts.values())}"
                               f" conflict(s): {detail}",
                    "reason": "Conflict",
                    "code": 409,
                }

            if existing is None:
                new_obj = {
                    "apiVersion": body.get("apiVersion"),
                    "kind": body.get("kind"),
                    "metadata": {"name": name},
                }
                if body.get("metadata", {}).get("namespace"):
                    new_obj["metadata"]["namespace"] = body["metadata"]["namespace"]
            else:
                new_obj = copy.deepcopy(existing)
                # Apply is declarative: fields this manager owned but no
                # longer applies are removed (unless co-owned by another).
                for p in owners.get(manager, set()) - applied_paths:
                    if not any(p in owned for m, owned in owners.items() if m != manager):
                        del_path(new_obj, p)
            for p in applied_paths:
                set_path(new_obj, p, copy.deepcopy(get_path(body, p)))

            # JobSet immutability (what the real JobSet validating webhook
            # enforces): spec.replicatedJobs — the pod template and gang
            # shape — cannot change on an existing object. Checked BEFORE
            # the ownership bookkeeping below, as a real apiserver rejects
            # in admission before persisting anything: a rejected apply
            # must not rewrite managed-field ownership. Surfacing this
            # keeps the fake honest about the one write the controller
            # must never attempt (it deletes-then-recreates instead), and
            # exercises the controller's immutable-rejection fallback for
            # legacy JobSets that predate the spec-hash record.
            if existing is not None and new_obj.get("kind") == "JobSet":
                old_rj = existing.get("spec", {}).get("replicatedJobs")
                new_rj = new_obj.get("spec", {}).get("replicatedJobs")
                if old_rj is not None and new_rj != old_rj:
                    return 422, {
                        "kind": "Status",
                        "apiVersion": "v1",
                        "status": "Failure",
                        "message": f'JobSet.jobset.x-k8s.io "{name}" is '
                                   "invalid: spec.replicatedJobs: Invalid "
                                   "value: field is immutable",
                        "reason": "Invalid",
                        "code": 422,
                    }

            if dry_run:
                return (200 if existing is not None else 201, new_obj)
            if final_obj is not None:
                new_obj = final_obj

            # Ownership: this manager owns what it applied; forced
            # conflicts transfer those paths away from previous owners.
            owners[manager] = set(applied_paths)
            for other, taken in conflicts.items():
                owners[other] -= taken
            new_obj.setdefault("metadata", {})["managedFields"] = [
                {"manager": m, "operation": "Apply", "fieldsV1": fields_v1(ps)}
                for m, ps in sorted(owners.items()) if ps
            ]

            if existing is not None:
                def strip_rv(o):
                    # Shallow: only metadata is rebuilt without rv. The
                    # old deepcopy-both-objects version was the fake's
                    # single hottest path (~1.5ms per no-op apply).
                    m = o.get("metadata")
                    if not isinstance(m, dict) or "resourceVersion" not in m:
                        return o
                    o2 = dict(o)
                    o2["metadata"] = {k: v for k, v in m.items() if k != "resourceVersion"}
                    return o2

                # Full-object comparison (metadata included — labels and
                # ownerReferences changes are real changes) modulo the
                # server-bumped resourceVersion.
                if strip_rv(new_obj) == strip_rv(existing):
                    return 200, existing  # no-op: rv unchanged
            return (200 if existing is not None else 201,
                    self.upsert(key, name, new_obj, assume_fresh=True))


class FakeKubeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "FakeKube/0.1"
    # Keep-alive + Nagle + delayed ACK = ~40ms per request; real API
    # servers disable Nagle, so do we.
    disable_nagle_algorithm = True

    # ---- plumbing ---------------------------------------------------------

    def log_message(self, *args):  # silence default stderr chatter
        pass

    @property
    def store(self) -> Store:
        return self.server.store  # type: ignore[attr-defined]

    def simulate_latency(self):
        """Optional per-request delay modelling a real API server's network
        + etcd round trip (a kind cluster sits at ~1-5ms). Benchmarks set
        this so architecture differences (serial vs parallel reconcile)
        surface instead of being masked by loopback speed."""
        delay = getattr(self.server, "latency_ms", 0)
        if delay:
            time.sleep(delay / 1000.0)

    def inject_fault(self) -> bool:
        """Fault injection (FakeKube(error_rate=...)): with probability
        error_rate, answer this WRITE with a 500 before touching the
        store — the overloaded/flaky-apiserver chaos mode. Reads stay
        clean (watch streams re-listing on every fault would test the
        relist path, not error-requeue convergence). Deterministic per
        construction seed so failures reproduce."""
        rate = getattr(self.server, "error_rate", 0)
        if not rate:
            return False
        rng = getattr(self.server, "fault_rng", None)
        if rng is None or rng.random() >= rate:
            return False
        self.send_status_error(500, "injected fault", "InternalError")
        return True

    def send_json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def send_status_error(self, code, message, reason=""):
        self.send_json(
            code,
            {
                "kind": "Status",
                "apiVersion": "v1",
                "status": "Failure",
                "message": message,
                "reason": reason,
                "code": code,
            },
        )

    def read_body(self):
        n = int(self.headers.get("Content-Length", "0"))
        return self.rfile.read(n) if n else b""

    # ---- path routing -----------------------------------------------------

    def route(self):
        """Parse path -> (coll_key, name, subresource, query).

        coll_key = (api_prefix, namespace, plural); namespace "" for
        cluster-scoped collections.
        """
        parsed = urlparse(self.path)
        query = parse_qs(parsed.query)
        parts = [p for p in parsed.path.split("/") if p]
        if not parts:
            return None
        if parts[0] == "api" and len(parts) >= 2:
            prefix = "api/" + parts[1]
            rest = parts[2:]
        elif parts[0] == "apis" and len(parts) >= 3:
            prefix = "apis/" + parts[1] + "/" + parts[2]
            rest = parts[3:]
        else:
            return None
        ns = ""
        # namespaced collection: namespaces/{ns}/{plural}[...]; but
        # /api/v1/namespaces[/name] is itself the cluster-scoped collection.
        if rest and rest[0] == "namespaces" and len(rest) >= 3:
            ns = rest[1]
            rest = rest[2:]
        if not rest:
            return None
        plural = rest[0]
        name = rest[1] if len(rest) > 1 else ""
        sub = rest[2] if len(rest) > 2 else ""
        return (prefix, ns, plural), name, sub, query

    # ---- verbs ------------------------------------------------------------

    def do_GET(self):
        self.simulate_latency()
        routed = self.route()
        if not routed:
            return self.send_status_error(404, f"unknown path {self.path}")
        key, name, sub, query = routed
        self.store.request_log.append(("GET", self.path))
        if name:
            with self.store.lock:
                obj = self.store.collection(key).get(name)
            if obj is None:
                return self.send_status_error(404, f"{key[2]} {name!r} not found", "NotFound")
            return self.send_json(200, obj)
        if query.get("watch", ["0"])[0] in ("1", "true"):
            return self.serve_watch(key, query)
        with self.store.lock:
            # References, not copies: stored objects are immutable (every
            # write path rebinds a fresh dict), so snapshotting the value
            # lists under the lock is enough.
            if key[1]:  # exact namespaced collection: one dict lookup
                items = list(self.store.collection(key).values())
            else:  # cluster-wide: fan out over every matching namespace
                items = [o
                         for coll_key, coll in sorted(self.store.objects.items())
                         if self._key_matches(key, coll_key)
                         for o in coll.values()]
            rv = str(self.store.rv)
        selector = query.get("labelSelector", [""])[0]
        if selector:
            try:
                items = [o for o in items if self._labels_match(o, selector)]
            except ValueError as e:
                # Loud HTTP 400, not a dropped connection: the C++ client
                # would retry a reset as transient and mask the bad config.
                return self.send_status_error(400, str(e), "BadRequest")
        self.send_json(
            200,
            {"kind": "List", "apiVersion": "v1", "metadata": {"resourceVersion": rv}, "items": items},
        )

    @staticmethod
    def _labels_match(obj, selector):
        """Equality-based label selector semantics (k=v, k!=v, bare k
        existence; comma = AND; whitespace around operators tolerated,
        as on the real apiserver) — the subset the synchronizer's
        node-inventory path uses. Set-based syntax (in/notin) is NOT
        implemented and rejects loudly rather than silently filtering
        everything out."""
        labels = (obj.get("metadata") or {}).get("labels") or {}
        for term in selector.split(","):
            term = term.strip()
            if not term:
                continue
            # '(' catches the no-space forms ("env in(prod)") the real
            # apiserver's lexer accepts; without it they would fall
            # through to the bare-key check and silently match nothing.
            if (" in " in term or " notin " in term
                    or term.endswith((" in", " notin")) or "(" in term):
                raise ValueError(
                    f"set-based label selector not implemented by the fake: {term!r}")
            if "!=" in term:
                k, v = term.split("!=", 1)
                if labels.get(k.strip()) == v.strip():
                    return False
            elif "=" in term:
                k, v = term.split("==", 1) if "==" in term else term.split("=", 1)
                if labels.get(k.strip()) != v.strip():
                    return False
            elif term not in labels:
                return False
        return True

    @staticmethod
    def _key_matches(requested, stored):
        """Collection match for a request key against a stored key. A
        request with an empty namespace is the cluster-wide collection
        (apiserver semantics: GET /apis/G/V/PLURAL spans all namespaces),
        so it matches every namespace of that (api, plural) pair."""
        if requested == stored:
            return True
        return not requested[1] and requested[0] == stored[0] and requested[2] == stored[2]

    def serve_watch(self, key, query):
        since = int(query.get("resourceVersion", ["0"])[0] or 0)
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def write_chunk(data: bytes):
            self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        # History before the compaction floor is gone: the client cannot
        # know what it missed and must re-list (apiserver 410 semantics,
        # delivered as an ERROR event on the established stream).
        with self.store.lock:
            compacted = self.store.compacted_through
        if since and since < compacted:
            err = json.dumps({
                "type": "ERROR",
                "object": {"kind": "Status", "apiVersion": "v1", "status": "Failure",
                           "reason": "Expired", "code": 410,
                           "message": f"too old resource version: {since} ({compacted})"},
            }) + "\n"
            try:
                write_chunk(err.encode())
                write_chunk(b"")  # end chunked stream
            except OSError:
                pass
            return

        import bisect

        cursor = since
        try:
            while True:
                batch = []
                expired = False
                with self.store.lock:
                    # A live-but-lagging watcher whose cursor fell behind
                    # the compaction floor has missed events it can never
                    # see — that is a mid-stream 410, same as at start.
                    if cursor and cursor < self.store.compacted_through:
                        expired = True
                    else:
                        # Events are append-only with increasing rv:
                        # binary search the resume point instead of
                        # scanning history on every wake (the fake must
                        # not become the bottleneck at 2,000 CRs).
                        events = self.store.events
                        start = bisect.bisect_right(events, cursor, key=lambda e: e[0])
                        for rv, ekey, etype, obj in events[start:]:
                            if self._key_matches(key, ekey):
                                # No copy: recorded objects are immutable
                                # (every write path rebinds a fresh dict),
                                # and serialization happens outside the
                                # lock — the deepcopy per watcher per
                                # event was the fake's hottest path.
                                batch.append((rv, etype, obj))
                        if not batch:
                            self.store.lock.wait(timeout=1.0)
                if expired:
                    err = json.dumps({
                        "type": "ERROR",
                        "object": {"kind": "Status", "apiVersion": "v1",
                                   "status": "Failure", "reason": "Expired", "code": 410,
                                   "message": f"too old resource version: {cursor}"},
                    }) + "\n"
                    write_chunk(err.encode())
                    write_chunk(b"")
                    return
                for rv, etype, obj in batch:
                    cursor = max(cursor, rv)
                    line = json.dumps({"type": etype, "object": obj}) + "\n"
                    write_chunk(line.encode())
        except (BrokenPipeError, ConnectionResetError, OSError):
            return

    # ---- write-path admission (fakeadmission.py) --------------------------

    def _user_info(self):
        """k8s impersonation headers carry the requester identity (the
        real apiserver derives it from authn; tests set these). Absent
        headers mean the cluster-admin the daemons and create_ub act as."""
        user = self.headers.get("Impersonate-User", "system:admin")
        groups = self.headers.get_all("Impersonate-Group") or ["system:masters"]
        return {"username": user, "groups": list(groups)}

    def _admit(self, key, op, name, obj, old_obj):
        """Webhook dispatch + CRD schema validation, exactly the real
        write path's order: mutate first, then validate the PATCHED
        object against the structural schema (a webhook patch the schema
        rejects must fail the write). Returns
        (final_obj, None) or (None, handled) after sending the error."""
        from tpu_bootstrap_torch import fakeadmission

        final, err = fakeadmission.dispatch(
            self.store, key, op, name, obj, old_obj, self._user_info())
        if err is not None:
            code, msg = err
            self.send_status_error(code, msg, "Forbidden" if code == 403 else "")
            return None, True
        if key == FakeKube.KEY_UB and final is not None:
            schema = fakeadmission.load_crd_schema()
            errors = fakeadmission.validate_crd_object(final, schema)
            if errors:
                self.send_status_error(
                    422, "; ".join(errors[:5]), "Invalid")
                return None, True
        return final, False

    def _admit_status(self, key, name, obj):
        """Schema-only validation for status subresource writes (the
        webhook's rules match the main resource, not the subresource)."""
        from tpu_bootstrap_torch import fakeadmission

        if key == FakeKube.KEY_UB:
            errors = fakeadmission.validate_crd_object(
                obj, fakeadmission.load_crd_schema())
            if errors:
                self.send_status_error(422, "; ".join(errors[:5]), "Invalid")
                return None, True
        return obj, False

    def do_POST(self):
        self.simulate_latency()
        raw = self.read_body()  # drain before any error return (keep-alive)
        if self.inject_fault():
            return
        routed = self.route()
        if not routed:
            return self.send_status_error(404, f"unknown path {self.path}")
        key, _, _, _ = routed
        obj = json.loads(raw)
        name = obj.get("metadata", {}).get("name")
        if not name:
            return self.send_status_error(400, "metadata.name required")
        with self.store.lock:
            if name in self.store.collection(key):
                return self.send_status_error(409, f"{name} already exists", "AlreadyExists")
        obj, handled = self._admit(key, "CREATE", name, obj, None)
        if handled:
            return
        self.store.request_log.append(("POST", self.path))
        with self.store.lock:
            # Re-check under the lock: the admission round trip released
            # it, and a racing POST for the same name may have landed —
            # exactly one writer may win AlreadyExists semantics.
            if name in self.store.collection(key):
                return self.send_status_error(409, f"{name} already exists", "AlreadyExists")
            return self.send_json(201, self.store.upsert(key, name, obj))

    def do_PATCH(self):
        self.simulate_latency()
        raw = self.read_body()  # drain before any error return (keep-alive)
        if self.inject_fault():
            return
        routed = self.route()
        if not routed:
            return self.send_status_error(404, f"unknown path {self.path}")
        key, name, sub, query = routed
        if not name:
            return self.send_status_error(405, "PATCH requires a name")
        ctype = self.headers.get("Content-Type", "")
        body = json.loads(raw)
        self.store.request_log.append(("PATCH", self.path))

        with self.store.lock:
            existing = copy.deepcopy(self.store.collection(key).get(name))

        if sub == "status":
            if existing is None:
                return self.send_status_error(404, f"{name} not found", "NotFound")
            if "merge-patch" not in ctype:
                return self.send_status_error(415, f"unsupported status patch type {ctype}")
            # The webhook matches the main resource only (the chart's
            # webhook rules name "userbootstraps", not the status
            # subresource) — but the apiserver's schema validation
            # covers status writes too. Same base_rv capture /
            # recheck-under-lock retry loop as the main-resource patch
            # paths: validation runs outside the lock, so a concurrent
            # status writer (synchronizer vs controller) could land in
            # the window and be clobbered by state derived from the
            # stale read — the exact race the other paths already close.
            for _attempt in range(5):
                base_rv = existing["metadata"]["resourceVersion"]
                work = copy.deepcopy(existing)
                work["status"] = merge_patch(work.get("status"),
                                             copy.deepcopy(body.get("status")))
                work, handled = self._admit_status(key, name, work)
                if handled:
                    return
                with self.store.lock:
                    cur = self.store.collection(key).get(name)
                    if cur is None:
                        return self.send_status_error(404, f"{name} not found", "NotFound")
                    if cur["metadata"]["resourceVersion"] == base_rv:
                        return self.send_json(
                            200, self.store.upsert(key, name, work, preserve_status=False))
                    existing = copy.deepcopy(cur)
            return self.send_status_error(
                409, "status patch retries exhausted against concurrent writers",
                "Conflict")

        if "apply-patch" in ctype:
            manager = query.get("fieldManager", ["unknown"])[0]
            force = query.get("force", ["false"])[0] in ("true", "1")
            # SSA traverses admission + schema validation like every
            # other write: dry-run compute -> admit (webhook round trip
            # outside the lock) -> persist the ADMITTED object, with an
            # rv re-check closing the admission window (apiserver-style
            # internal retry).
            for _attempt in range(5):
                with self.store.lock:
                    cur = self.store.collection(key).get(name)
                    base_rv = cur["metadata"]["resourceVersion"] if cur else None
                    old = copy.deepcopy(cur)
                code, candidate = self.store.server_side_apply(
                    key, name, body, manager, force, dry_run=True)
                if code >= 400:
                    return self.send_json(code, candidate)
                final, handled = self._admit(
                    key, "UPDATE" if old is not None else "CREATE",
                    name, candidate, old)
                if handled:
                    return
                with self.store.lock:
                    cur2 = self.store.collection(key).get(name)
                    rv2 = cur2["metadata"]["resourceVersion"] if cur2 else None
                    if rv2 == base_rv:
                        code, payload = self.store.server_side_apply(
                            key, name, body, manager, force, final_obj=final)
                        return self.send_json(code, payload)
            return self.send_status_error(
                409, "apply retries exhausted against concurrent writers",
                "Conflict")
        if "json-patch" in ctype or "merge-patch" in ctype:
            if existing is None:
                return self.send_status_error(404, f"{name} not found", "NotFound")
            # Apiserver-style patch loop: the admission round trip happens
            # OUTSIDE the store lock, so a concurrent write can land in
            # the window; like the real apiserver we then recompute the
            # patch against the fresh object instead of silently
            # clobbering the concurrent write with state derived from the
            # stale read.
            for _attempt in range(5):
                base_rv = existing["metadata"]["resourceVersion"]
                work = copy.deepcopy(existing)
                if "json-patch" in ctype:
                    try:
                        patched = apply_json_patch(work, body)
                    except Exception as e:  # noqa: BLE001
                        return self.send_status_error(422, f"invalid patch: {e}", "Invalid")
                else:
                    patched = merge_patch(work, copy.deepcopy(body))
                patched, handled = self._admit(key, "UPDATE", name, patched, existing)
                if handled:
                    return
                with self.store.lock:
                    cur = self.store.collection(key).get(name)
                    if cur is None:
                        return self.send_status_error(404, f"{name} not found", "NotFound")
                    if cur["metadata"]["resourceVersion"] == base_rv:
                        return self.send_json(
                            200, self.store.upsert(key, name, patched, preserve_status=False))
                    existing = copy.deepcopy(cur)
            return self.send_status_error(
                409, "patch retries exhausted against concurrent writers", "Conflict")
        return self.send_status_error(415, f"unsupported patch type {ctype}")

    def do_PUT(self):
        self.simulate_latency()
        raw = self.read_body()  # drain before any error return (keep-alive)
        if self.inject_fault():
            return
        routed = self.route()
        if not routed:
            return self.send_status_error(404, f"unknown path {self.path}")
        key, name, sub, _ = routed
        body = json.loads(raw)
        self.store.request_log.append(("PUT", self.path))
        # Admission dispatch (a blocking webhook round trip) must happen
        # OUTSIDE the store lock — holding it would stall every other
        # request for up to the webhook timeout. The PUT's optimistic-
        # concurrency contract survives because the caller's pinned
        # resourceVersion is re-checked inside the lock right before the
        # write: two racing PUTs pinning the same rv still resolve to
        # exactly one 200 and one 409 (leader election depends on that),
        # whether or not a webhook ran in between.
        def rv_gate():
            existing = copy.deepcopy(self.store.collection(key).get(name))
            if existing is None:
                return None, self.send_status_error(404, f"{name} not found", "NotFound")
            want_rv = body.get("metadata", {}).get("resourceVersion")
            if want_rv and want_rv != existing["metadata"]["resourceVersion"]:
                # Optimistic concurrency (the synchronizer and the
                # lease updates rely on this).
                return None, self.send_status_error(
                    409,
                    f"resourceVersion conflict: have {existing['metadata']['resourceVersion']}, "
                    f"got {want_rv}",
                    "Conflict",
                )
            return existing, None

        # Unpinned PUTs are last-write-wins on a real apiserver, so a
        # concurrent write landing during the admission window triggers a
        # RE-ADMIT against the fresh object, not a 409 — only a
        # caller-pinned rv conflicts (and that is decided by rv_gate).
        for _attempt in range(5):
            with self.store.lock:
                existing, err = rv_gate()
                if existing is None:
                    return err
            if sub == "status":
                staged = dict(existing)
                staged["status"] = body.get("status", {})
                final, handled = self._admit_status(key, name, staged)
                preserve = False
            else:
                final, handled = self._admit(key, "UPDATE", name, body, existing)
                preserve = True
            if handled:
                return
            with self.store.lock:
                recheck, err = rv_gate()
                if recheck is None:
                    return err
                if (recheck["metadata"]["resourceVersion"]
                        == existing["metadata"]["resourceVersion"]):
                    result = self.store.upsert(key, name, final,
                                               preserve_status=preserve)
                    return self.send_json(200, result)
        return self.send_status_error(
            409, "update retries exhausted against concurrent writers",
            "Conflict")

    def do_DELETE(self):
        self.simulate_latency()
        if self.inject_fault():
            return
        routed = self.route()
        if not routed:
            return self.send_status_error(404, f"unknown path {self.path}")
        key, name, _, _ = routed
        with self.store.lock:
            old = copy.deepcopy(self.store.collection(key).get(name))
        if old is not None:
            _, handled = self._admit(key, "DELETE", name, None, old)
            if handled:
                return
        self.store.request_log.append(("DELETE", self.path))
        obj = self.store.delete(key, name)
        if obj is None:
            return self.send_status_error(404, f"{name} not found", "NotFound")
        return self.send_json(200, obj)


class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that remembers live client sockets so stop()
    can sever them. Plain shutdown() only stops the accept loop; handler
    threads keep serving keep-alive connections, so a daemon with a
    pooled connection would still see a perfectly healthy "API server"
    after the fake is nominally dead."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns = set()
        self._conns_lock = threading.Lock()

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self):
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class FakeKube:
    """In-process fake API server handle for tests."""

    def __init__(self, port: int = 0, latency_ms: float = 0, event_horizon: int = 100_000,
                 error_rate: float = 0.0, fault_seed: int = 0):
        self.store = Store(event_horizon=event_horizon)
        self.httpd = _TrackingHTTPServer(("127.0.0.1", port), FakeKubeHandler)
        self.httpd.store = self.store  # type: ignore[attr-defined]
        self.httpd.latency_ms = latency_ms  # type: ignore[attr-defined]
        # Chaos mode: writes fail with 500 at this rate (see inject_fault).
        self.httpd.error_rate = error_rate  # type: ignore[attr-defined]
        self.httpd.fault_rng = random.Random(fault_seed)  # type: ignore[attr-defined]
        self.httpd.daemon_threads = True
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self):
        self.thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        # Sever live keep-alive connections: a stopped API server must look
        # dead to clients holding pooled connections, not half-alive.
        self.httpd.close_all_connections()

    # -- convenience accessors for tests ------------------------------------

    KEY_UB = ("apis/tpu.bacchus.io/v1", "", "userbootstraps")

    def create_ub(self, name, spec=None, status=None):
        obj = {
            "apiVersion": "tpu.bacchus.io/v1",
            "kind": "UserBootstrap",
            "metadata": {"name": name},
            "spec": spec or {},
        }
        if status is not None:
            obj["status"] = status
        return self.store.upsert(self.KEY_UB, name, obj)

    def get(self, key, name):
        with self.store.lock:
            return copy.deepcopy(self.store.collection(key).get(name))

    def list_names(self, key):
        with self.store.lock:
            return sorted(self.store.collection(key))


def main():
    parser = argparse.ArgumentParser(
        prog="python -m tpu_bootstrap_torch.fakeapi",
        description="fake Kubernetes API server")
    parser.add_argument("--port", type=int, default=8001)
    args = parser.parse_args()
    server = FakeKube(args.port).start()
    print(f"fake API server on {server.url}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
