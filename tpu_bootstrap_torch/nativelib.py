"""ctypes bridge to the native core (libtpubc_capi.so), built for the port.

The same bridge as ``tpu_bootstrap.nativelib`` (the port imports nothing of
the JAX package): the daemons' policy and planning cores called in process
through the C shim, and ``build_native`` to compile the shim and the four
daemons from ``native/``. The sources are only read: the port builds out
of tree into ``build/native/`` at the repository's root, never into
``native/build/``, and one ``fcntl.flock`` on a lock file there serialises
concurrent builds (several test workers, or a smoke run beside them, may
call ``build_native`` at once on a fresh checkout).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import json
import os
import shutil
import subprocess
from pathlib import Path
from typing import Any

REPO_ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "native"
LIB_PATH = BUILD_DIR / "libtpubc_capi.so"

DAEMONS = ("crdgen", "controller", "admission", "synchronizer")


def _libssl_flags() -> list:
    """Link whichever OpenSSL runtime the image ships (the declared ABI in
    tls.h is stable since 1.1)."""
    if Path("/usr/lib/x86_64-linux-gnu/libssl.so.3").exists():
        return ["-l:libssl.so.3", "-l:libcrypto.so.3"]
    return ["-l:libssl.so.1.1", "-l:libcrypto.so.1.1"]


def _build_fallback(force: bool = False) -> None:
    """Direct g++ build for images without cmake/ninja (mirrors
    CMakeLists.txt: one core objects set -> capi .so + four daemons,
    -Wall -Wextra -Werror, TPUBC_SANITIZE presets). Object files are
    cached by mtime against their source and the newest header, so
    incremental edits recompile only what changed; sanitizer modes keep
    their own object dirs and a mode stamp forces a relink when the mode
    changes (a libtpubc_capi.so still carrying the last run's TSan
    instrumentation would poison every non-sanitizer caller)."""
    sanitize = os.environ.get("TPUBC_SANITIZE", "")
    obj_dir = BUILD_DIR / (f"obj-{sanitize.replace(',', '-')}" if sanitize
                           else "obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    stamp = BUILD_DIR / ".sanitize-mode"
    prior = stamp.read_text() if stamp.exists() else ""
    relink = force or prior != sanitize
    include = NATIVE_DIR / "include"
    newest_header = max(p.stat().st_mtime for p in include.rglob("*.h"))
    cxx = ["g++", "-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
           "-Werror", f"-I{include}"]
    san_flags = ([f"-fsanitize={sanitize}", "-fno-omit-frame-pointer",
                  "-g"] if sanitize else [])
    cxx += san_flags

    def compile_one(src: Path) -> Path:
        obj = obj_dir / (src.stem + ".o")
        if (force or not obj.exists()
                or obj.stat().st_mtime < max(src.stat().st_mtime,
                                             newest_header)):
            subprocess.run(cxx + ["-c", str(src), "-o", str(obj)],
                           check=True, capture_output=True)
        return obj

    core = [compile_one(src)
            for src in sorted((NATIVE_DIR / "src").glob("*.cc"))
            if src.name != "capi.cc"]
    capi = compile_one(NATIVE_DIR / "src" / "capi.cc")
    link = _libssl_flags() + ["-lpthread"]

    def link_if_stale(out: Path, objs: list, extra: list) -> None:
        if (not relink and out.exists()
                and out.stat().st_mtime >= max(o.stat().st_mtime
                                               for o in objs)):
            return
        subprocess.run(["g++"] + extra + san_flags + [str(o) for o in objs]
                       + ["-o", str(out)] + link,
                       check=True, capture_output=True)

    link_if_stale(LIB_PATH, [capi] + core, ["-shared"])
    for daemon in DAEMONS:
        bin_obj = compile_one(NATIVE_DIR / "bin" / f"{daemon}.cc")
        link_if_stale(BUILD_DIR / f"tpubc-{daemon}", [bin_obj] + core, [])
    stamp.write_text(sanitize)


@contextlib.contextmanager
def _build_lock():
    """An exclusive ``flock`` on ``BUILD_DIR/.build.lock`` for the length of
    one build: a second caller waits, then finds the tree up to date. The
    kernel drops the lock when its holder exits, so a killed build leaves
    nothing to clean up."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _cmake_cache() -> dict:
    """NAME -> value of BUILD_DIR's CMakeCache.txt ({} when there is none)."""
    path = BUILD_DIR / "CMakeCache.txt"
    if not path.exists():
        return {}
    out = {}
    for line in path.read_text(errors="replace").splitlines():
        if line[:1] not in ("", "#", "/") and "=" in line:
            key, _, value = line.partition("=")
            out[key.split(":", 1)[0]] = value
    return out


def _configured_here() -> bool:
    """Whether BUILD_DIR holds a CMake configuration that this host can
    rebuild: made for these source and build directories, and naming a
    cmake, its modules, a ninja and a compiler that exist here. A tree
    configured on another machine (or moved) fails this, and ninja would
    otherwise try to regenerate it with tools that are not here."""
    if not (BUILD_DIR / "build.ninja").exists():
        return False
    cache = _cmake_cache()

    def same_dir(key: str, want: Path) -> bool:
        return bool(cache.get(key)) and Path(cache[key]).resolve() == \
            want.resolve()

    return (same_dir("CMAKE_HOME_DIRECTORY", NATIVE_DIR)
            and same_dir("CMAKE_CACHEFILE_DIR", BUILD_DIR)
            and all(cache.get(k) and Path(cache[k]).exists()
                    for k in ("CMAKE_COMMAND", "CMAKE_ROOT",
                              "CMAKE_MAKE_PROGRAM", "CMAKE_CXX_COMPILER")))


def _clear_build_dir() -> None:
    """Everything in BUILD_DIR but the lock file its caller holds."""
    for p in BUILD_DIR.iterdir():
        if p.name == ".build.lock":
            continue
        if p.is_dir() and not p.is_symlink():
            shutil.rmtree(p)
        else:
            p.unlink()


def build_native(force: bool = False) -> None:
    """Configure and build the native tree into BUILD_DIR (cached: ninja
    makes this a no-op). Falls back to a direct g++ build when cmake or
    ninja is not installed. TPUBC_SANITIZE in the environment selects the
    sanitizer preset on either path (the CMake ``-DTPUBC_SANITIZE=...``
    cache entry, or the fallback's flags); switching modes reconfigures,
    so a stale instrumented build never leaks into a plain run. A
    configuration this host cannot rebuild (``_configured_here``: made on
    another machine or in another directory) is cleared and made anew."""
    with _build_lock():
        if shutil.which("cmake") is None or shutil.which("ninja") is None:
            _build_fallback(force)
            return
        sanitize = os.environ.get("TPUBC_SANITIZE", "")
        stamp = BUILD_DIR / ".sanitize-mode"
        prior = stamp.read_text() if stamp.exists() else ""
        here = _configured_here()
        if not here:
            _clear_build_dir()
        if not here or prior != sanitize:
            subprocess.run(
                ["cmake", "-S", str(NATIVE_DIR), "-B", str(BUILD_DIR),
                 "-G", "Ninja", f"-DTPUBC_SANITIZE={sanitize}"],
                check=True, capture_output=True)
        subprocess.run(["ninja", "-C", str(BUILD_DIR)], check=True,
                       capture_output=True)
        stamp.write_text(sanitize)


class NativeError(RuntimeError):
    """An {"error": ...} payload surfaced from the native core."""


class NativeLib:
    def __init__(self, path: os.PathLike | None = None):
        build_native()
        self._lib = ctypes.CDLL(str(path or LIB_PATH))
        self._lib.tpubc_free.argtypes = [ctypes.c_void_p]
        self._lib.tpubc_free.restype = None

    def _call(self, name: str, *args: str) -> str:
        fn = getattr(self._lib, name)
        # Every tpubc_* function returns a malloc'd char*: set restype on
        # first use (a default int restype would truncate the pointer).
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_char_p] * len(args)
        ptr = fn(*[a.encode("utf-8") for a in args])
        try:
            return ctypes.string_at(ptr).decode("utf-8")
        finally:
            self._lib.tpubc_free(ptr)

    def _call_json(self, name: str, *args: Any) -> Any:
        encoded = [a if isinstance(a, str) else json.dumps(a) for a in args]
        out = json.loads(self._call(name, *encoded))
        if isinstance(out, dict) and set(out.keys()) == {"error"}:
            raise NativeError(out["error"])
        return out

    # -- raw string APIs ----------------------------------------------------
    def version(self) -> str:
        return self._call("tpubc_version")

    def crd_yaml(self) -> str:
        return self._call("tpubc_crd_yaml")

    def to_yaml(self, value: Any) -> str:
        return self._call("tpubc_to_yaml", json.dumps(value))

    def default_topology(self, accelerator: str) -> str:
        out = self._call("tpubc_default_topology", accelerator)
        if out.startswith('{"error"'):
            raise NativeError(json.loads(out)["error"])
        return out

    def infer_header(self, header: str) -> str:
        return self._call("tpubc_infer_header", header)

    def sha256_hex(self, data: str) -> str:
        return self._call("tpubc_sha256_hex", data)

    def base64_encode(self, data: str) -> str:
        return self._call("tpubc_base64_encode", data)

    def base64_decode(self, data: str) -> str:
        return self._call("tpubc_base64_decode", data)

    # -- JSON APIs ----------------------------------------------------------
    def crd(self) -> dict:
        return self._call_json("tpubc_crd_json")

    def json_roundtrip(self, text: str) -> Any:
        return self._call_json("tpubc_json_roundtrip", text)

    def json_patch(self, doc: Any, patch: Any) -> Any:
        return self._call_json("tpubc_json_patch", doc, patch)

    def validate_topology(self, accelerator: str, topology: str) -> dict:
        return self._call_json("tpubc_validate_topology", accelerator,
                               topology)

    def slice_geometry(self, accelerator: str, topology: str) -> dict:
        return self._call_json("tpubc_slice_geometry", accelerator, topology)

    def classify_username(self, username: str, prefix: str) -> dict:
        return self._call_json("tpubc_classify_username", username, prefix)

    def default_admission_config(self) -> dict:
        return self._call_json("tpubc_default_admission_config")

    def mutate(self, request: Any, config: Any) -> dict:
        return self._call_json("tpubc_mutate", request, config)

    def mutate_review(self, review: Any, config: Any) -> dict:
        return self._call_json("tpubc_mutate_review", review, config)

    def default_controller_config(self) -> dict:
        return self._call_json("tpubc_default_controller_config")

    def desired_children(self, ub: Any, config: Any | None = None) -> list:
        return self._call_json(
            "tpubc_desired_children", ub,
            config or self.default_controller_config())

    def build_jobset(self, ub: Any, config: Any | None = None) -> dict:
        return self._call_json(
            "tpubc_build_jobset", ub,
            config or self.default_controller_config())

    def slice_status(self, ub: Any, jobset: Any) -> dict:
        return self._call_json("tpubc_slice_status", ub, jobset)

    def jobset_spec_changed(self, ub: Any, desired_jobset: Any) -> bool:
        return self._call_json("tpubc_jobset_spec_changed", ub,
                               desired_jobset)

    def slice_event(self, ub: Any, old_phase: str, new_slice: Any,
                    timestamp: str) -> dict | None:
        # ub goes as JSON even when the caller hands over a dict with only
        # metadata; old_phase and timestamp are raw strings.
        return self._call_json("tpubc_slice_event", ub, old_phase, new_slice,
                               timestamp)

    def refresh_event(self, prev: Any, fresh: Any) -> dict:
        return self._call_json("tpubc_refresh_event", prev, fresh)

    def parse_sheet(self, csv_text: str) -> dict:
        return self._call_json("tpubc_parse_sheet", csv_text)

    def default_synchronizer_config(self) -> dict:
        return self._call_json("tpubc_default_synchronizer_config")

    def build_quota(self, row: Any, device: str = "tpu") -> dict:
        return self._call_json("tpubc_build_quota", row, device)

    def node_pool_capacity(self, nodes: Any, device: str = "tpu") -> int:
        return int(self._call("tpubc_node_pool_capacity", json.dumps(nodes),
                              device))

    def plan_sync(self, ub_list: Any, rows: Any,
                  config: Any | None = None) -> dict:
        return self._call_json(
            "tpubc_plan_sync", ub_list, rows,
            config or self.default_synchronizer_config())

    # -- telemetry (tracing / metrics / log filtering) ----------------------
    def trace_dump(self) -> dict:
        """{"process", "dropped", "spans": [...]} from the in-process
        tracer."""
        return self._call_json("tpubc_trace_dump")

    def trace_chrome(self) -> dict:
        """Chrome trace-event JSON ({"traceEvents": [...]})."""
        return self._call_json("tpubc_trace_chrome")

    def trace_reset(self) -> None:
        self._call_json("tpubc_trace_reset")

    def trace_test_span(self, name: str, trace_id: str = "",
                        parent_id: str = "") -> dict:
        return self._call_json("tpubc_trace_test_span", name, trace_id,
                               parent_id)

    def metrics_inc(self, name: str, delta: int = 1) -> None:
        self._call_json("tpubc_metrics_inc", name, str(delta))

    def metrics_observe(self, name: str, value: float) -> None:
        self._call_json("tpubc_metrics_observe", name, str(value))

    def metrics_quantile(self, name: str, q: float) -> float:
        return float(self._call("tpubc_metrics_quantile", name, str(q)))

    def metrics_json(self) -> dict:
        return self._call_json("tpubc_metrics_json")

    def metrics_prometheus(self) -> str:
        return self._call("tpubc_metrics_prometheus")

    def metrics_reset(self) -> None:
        self._call_json("tpubc_metrics_reset")

    def log_level_for(self, spec: str, target: str) -> str:
        """Effective level for a target under a TPUBC_LOG directive spec."""
        return self._call("tpubc_log_level_for", spec, target)

    def log_ratelimit_allow(self, target: str, message: str,
                            now_ms: int) -> bool:
        """Warning-flood token bucket probe at an explicit clock."""
        return self._call_json("tpubc_log_ratelimit_allow", target, message,
                               str(now_ms))

    def log_ratelimit_reset(self) -> None:
        self._call_json("tpubc_log_ratelimit_reset")

    # -- statusz flight recorder --------------------------------------------
    def statusz_record(self, obj: str, entry: dict) -> None:
        """Append one outcome to an object's /statusz ring. Entry keys:
        ts_ms, op, duration_ms, error, trace_id, detail (all optional)."""
        self._call_json("tpubc_statusz_record", obj, entry)

    def statusz_set_state(self, key: str, value: Any) -> None:
        self._call_json("tpubc_statusz_set_state", key, json.dumps(value))

    def statusz(self, object_filter: str = "") -> dict:
        """The /statusz document (optionally filtered to one object)."""
        return self._call_json("tpubc_statusz_json", object_filter)

    def statusz_reset(self) -> None:
        self._call_json("tpubc_statusz_reset")

    def workload_summary(self, metrics: Any, scraped_at: str) -> dict | None:
        """status.slice.workload block from a worker /metrics.json
        scrape."""
        return self._call_json("tpubc_workload_summary", metrics, scraped_at)


_shared: NativeLib | None = None


def get() -> NativeLib:
    global _shared
    if _shared is None:
        _shared = NativeLib()
    return _shared
