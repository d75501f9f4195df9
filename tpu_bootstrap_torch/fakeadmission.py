"""The fake apiserver's WRITE-PATH admission, for the port's ``fakeapi``:
MutatingWebhookConfiguration dispatch + CRD structural-schema validation.
A copy of ``tpu_bootstrap.fakeadmission`` (the port imports nothing of the
JAX package).

The deployed topology registers admission INLINE in the apiserver write
path with ``failurePolicy: Fail``: every CREATE/UPDATE/DELETE of a
UserBootstrap traverses the webhook BEFORE etcd, and the apiserver then
validates the patched object against the CRD's structural schema. The
fake apiserver reproduces that write path: register a
MutatingWebhookConfiguration (the REAL resource, stored like any other
object) and every UserBootstrap write is reviewed by the REAL admission
daemon over TLS, its JSONPatch applied, and the result schema-validated
against the chart's generated crd.yaml (read only) before anything
persists. A denied CREATE that persists anyway, a webhook patch the CRD
schema rejects and the failurePolicy semantics are all testable that way.

Schema semantics follow the real apiserver's structural-schema rules:
unknown fields are PRUNED (not rejected); type/enum/format violations
REJECT the write with a 422.
"""

from __future__ import annotations

import base64
import json
import re
import ssl
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CRD_YAML = REPO / "charts" / "tpu-bootstrap-controller" / "templates" / "crd.yaml"

KEY_WEBHOOKS = ("apis/admissionregistration.k8s.io/v1", "",
                "mutatingwebhookconfigurations")

# ---------------------------------------------------------------------------
# CRD structural schema
# ---------------------------------------------------------------------------

_schema_cache: dict = {}


def load_crd_schema():
    """openAPIV3Schema of the served version from the chart's generated
    crd.yaml (the drift-gated artifact — validating against it means the
    fake enforces exactly what a real apiserver with our CRD would).
    None when PyYAML or the chart file is unavailable."""
    if "schema" in _schema_cache:
        return _schema_cache["schema"]
    schema = None
    try:
        import yaml

        crd = yaml.safe_load(CRD_YAML.read_text())
        schema = crd["spec"]["versions"][0]["schema"]["openAPIV3Schema"]
    except Exception:  # noqa: BLE001
        schema = None
    _schema_cache["schema"] = schema
    return schema


_INT_OR_STRING = "x-kubernetes-int-or-string"
_PRESERVE = "x-kubernetes-preserve-unknown-fields"


def validate_crd_object(obj, schema, path="") -> list:
    """Validate ``obj`` against a structural openAPIV3Schema IN PLACE:
    unknown object properties are pruned (k8s structural pruning);
    returned list holds the violations that reject the write."""
    errors = []
    if schema is None:
        return errors
    if obj is None:
        # Explicit null: fine for nullable properties, 422 otherwise
        # (a real apiserver answers "Invalid value: null").
        if not schema.get("nullable"):
            errors.append(f"{path or '.'}: null for non-nullable field")
        return errors
    stype = schema.get("type")
    if schema.get(_INT_OR_STRING):
        if not isinstance(obj, (int, str)) or isinstance(obj, bool):
            errors.append(f"{path or '.'}: expected integer-or-string")
        return errors
    if stype == "object" or (stype is None and isinstance(obj, dict)):
        if not isinstance(obj, dict):
            errors.append(f"{path or '.'}: expected object, got {type(obj).__name__}")
            return errors
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        for k in list(obj.keys()):
            if path == "" and k in ("apiVersion", "kind", "metadata"):
                continue  # implicitly preserved on every structural schema
            if k in props:
                if obj[k] is None and props[k].get("nullable"):
                    continue
                errors.extend(validate_crd_object(obj[k], props[k], f"{path}.{k}"))
            elif isinstance(addl, dict):
                errors.extend(validate_crd_object(obj[k], addl, f"{path}.{k}"))
            elif addl is True or schema.get(_PRESERVE) or not props:
                continue
            else:
                # structural pruning: silently drop unknown fields
                del obj[k]
        for k, sub in props.items():
            # apiserver-style defaulting: a missing property with a
            # schema default materializes on write.
            if k not in obj and "default" in sub:
                obj[k] = json.loads(json.dumps(sub["default"]))
        for req in schema.get("required", []):
            if req not in obj:
                errors.append(f"{path or '.'}: missing required field {req!r}")
    elif stype == "array":
        if not isinstance(obj, list):
            errors.append(f"{path or '.'}: expected array, got {type(obj).__name__}")
            return errors
        item_schema = schema.get("items")
        for i, item in enumerate(obj):
            errors.extend(validate_crd_object(item, item_schema, f"{path}[{i}]"))
    elif stype == "string":
        if not isinstance(obj, str):
            errors.append(f"{path or '.'}: expected string, got {type(obj).__name__}")
        elif "pattern" in schema and not re.search(schema["pattern"], obj):
            errors.append(f"{path or '.'}: {obj!r} does not match {schema['pattern']!r}")
    elif stype == "integer":
        if isinstance(obj, bool) or not isinstance(obj, int):
            errors.append(f"{path or '.'}: expected integer, got {type(obj).__name__}")
        else:
            if "minimum" in schema and obj < schema["minimum"]:
                errors.append(f"{path or '.'}: {obj} < minimum {schema['minimum']}")
            if "maximum" in schema and obj > schema["maximum"]:
                errors.append(f"{path or '.'}: {obj} > maximum {schema['maximum']}")
    elif stype == "number":
        if isinstance(obj, bool) or not isinstance(obj, (int, float)):
            errors.append(f"{path or '.'}: expected number, got {type(obj).__name__}")
    elif stype == "boolean":
        if not isinstance(obj, bool):
            errors.append(f"{path or '.'}: expected boolean, got {type(obj).__name__}")
    if "enum" in schema and obj not in schema["enum"] and not (
            obj is None and schema.get("nullable")):
        errors.append(f"{path or '.'}: {obj!r} not one of {schema['enum']}")
    return errors


# ---------------------------------------------------------------------------
# Webhook dispatch
# ---------------------------------------------------------------------------


def _rule_matches(rule, group: str, version: str, plural: str, op: str) -> bool:
    ops = rule.get("operations", ["*"])
    if "*" not in ops and op not in ops:
        return False
    groups = rule.get("apiGroups", ["*"])
    if "*" not in groups and group not in groups:
        return False
    versions = rule.get("apiVersions", ["*"])
    if "*" not in versions and version not in versions:
        return False
    resources = rule.get("resources", ["*"])
    return "*" in resources or plural in resources


def matching_webhooks(store, key, op: str) -> list:
    """Webhook entries (from every registered MutatingWebhookConfiguration)
    whose rules match this (collection key, operation)."""
    prefix, _ns, plural = key
    if prefix.startswith("apis/"):
        group, _, version = prefix[len("apis/"):].partition("/")
    else:  # core: "api/v1"
        group, version = "", prefix.partition("/")[2]
    with store.lock:
        configs = [json.loads(json.dumps(c))
                   for c in store.collection(KEY_WEBHOOKS).values()]
    hooks = []
    for cfg in configs:
        for hook in cfg.get("webhooks", []):
            if any(_rule_matches(r, group, version, plural, op)
                   for r in hook.get("rules", [])):
                hooks.append(hook)
    return hooks


def _webhook_ssl_context(hook):
    ca = hook.get("clientConfig", {}).get("caBundle")
    if not ca:
        return None
    ctx = ssl.create_default_context()
    ctx.check_hostname = False  # CN-only self-signed test certs
    ctx.load_verify_locations(cadata=base64.b64decode(ca).decode())
    return ctx


def dispatch(store, key, op: str, name: str, obj, old_obj, user_info):
    """Run every matching webhook in order, threading the (possibly
    patched) object through. Returns (final_obj, None) or
    (None, (http_code, message)) when a webhook denies or an unreachable
    webhook's failurePolicy is Fail."""
    hooks = matching_webhooks(store, key, op)
    if not hooks:
        return obj, None
    for hook in hooks:
        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": f"fake-{name}-{op.lower()}",
                "operation": op,
                "name": name,
                "userInfo": user_info,
                "object": obj,
                "oldObject": old_obj,
            },
        }
        url = hook.get("clientConfig", {}).get("url")
        fail_policy = hook.get("failurePolicy", "Fail")
        timeout = hook.get("timeoutSeconds", 10)
        try:
            req = urllib.request.Request(
                url, data=json.dumps(review).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(
                    req, timeout=timeout, context=_webhook_ssl_context(hook)) as r:
                resp = json.loads(r.read())["response"]
        except Exception as e:  # noqa: BLE001 — unreachable/timeout/bad TLS
            if fail_policy == "Ignore":
                continue
            return None, (500, f"admission webhook {hook.get('name', '?')} "
                               f"failed: {type(e).__name__}: {e}")
        if not resp.get("allowed", False):
            msg = (resp.get("status") or {}).get("message", "admission denied")
            return None, (403, msg)
        patch_b64 = resp.get("patch")
        if patch_b64:
            from tpu_bootstrap_torch.fakeapi import apply_json_patch

            patch = json.loads(base64.b64decode(patch_b64))
            obj = apply_json_patch(obj if obj is not None else {}, patch)
    return obj, None


__all__ = ["KEY_WEBHOOKS", "dispatch", "load_crd_schema",
           "matching_webhooks", "validate_crd_object"]
