"""Mirrors of the reference's tests/test_ingress.py:65-129 and :258-405:
the front door on the replay-slot engine (float KV, the reference's
default), on the f32 bridged int8 weights of tests/test_torch_scheduler.py,
plain and speculative (the int8 model drafting for itself). Plain, every
request goes to the reference's server and the port's and every answer is
held to the other's and to solo greedy ``generate``; speculative, to the
port's server alone (the reference's verify rounds compile a program a
shape, which the 60 s budget of this file does not hold), held to solo
``generate`` (greedy verify-commit rounds commit the target's own
argmaxes). The sampled case (:234) becomes the sampling raise
(tests/test_torch_ingress.py, queue 1 item 5). :130-257 drive the native
controller daemon's serve-mode reconcile into a JobSet and a Service,
which is not ported: left out."""

import threading

import numpy as np
import pytest
import torch

from tests.test_torch_ingress import (
    HTTP_TIMEOUT,
    check_keys,
    get,
    post,
    solo,
    tokens_of,
)
from tests.test_torch_scheduler import JCFG, JPARAMS, TCFG, TPARAMS
from tpu_bootstrap.workload import ingress as jingress
from tpu_bootstrap_torch.workload import ingress as tingress

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["plain", "speculative"])
def servers(request):
    """The running servers, the port's last: plain, the reference's and
    the port's slot-engine servers; speculative, the port's drafted by the
    int8 model itself."""
    out = []
    kw = dict(port=0, batch_size=4, host="127.0.0.1")
    if request.param == "plain":
        out.append(jingress.IngressServer(JPARAMS, JCFG, **kw).start())
        out.append(tingress.IngressServer(TPARAMS, TCFG, device="cpu",
                                          **kw).start())
    else:
        out.append(tingress.IngressServer(
            TPARAMS, TCFG, device="cpu", draft_params=TPARAMS,
            draft_cfg=TCFG, gamma=3, **kw).start())
    yield out
    for srv in out:
        srv.stop()


def _same(answers: list):
    """Every server's answer equal to the port's; the port's."""
    assert all(a == answers[-1] for a in answers), answers
    return answers[-1]


def _healthz(port):
    code, h = get(port, "/healthz")
    assert code == 200
    return h


def test_healthz(servers):
    for srv in servers:
        h = _healthz(srv.port)
        assert h["ok"] is True and h["active"] >= 0 and h["queued"] >= 0
        assert h["beat_age_ms"] >= 0
        check_keys("/healthz", h, _healthz(servers[0].port))


def test_concurrent_streams_bit_match_solo(servers):
    """More clients than slots (6 against 4), mixed sizes and stream
    modes, all at once, on every server: every answer equals the other
    package's and its solo greedy generate."""
    rng = np.random.default_rng(0)
    jobs = [(rng.integers(1, TCFG.vocab_size,
                          int(rng.integers(2, 9))).tolist(),
             int(rng.integers(1, 13)), bool(i % 2)) for i in range(6)]
    results = {}
    errors = []

    def client(srv, i):
        try:
            tokens, max_new, stream = jobs[i]
            code, _, ans = post(srv.port, {"tokens": tokens,
                                           "max_new": max_new,
                                           "stream": stream})
            assert code == 200
            if stream:
                assert ans[-1]["done"] is True
            results[(srv.port, i)] = tokens_of(ans)
        except Exception as e:  # noqa: BLE001
            errors.append(f"{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(srv, i))
               for srv in servers for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    assert not errors, errors
    for i, (tokens, max_new, _) in enumerate(jobs):
        got = _same([results[(srv.port, i)] for srv in servers])
        assert got == solo(tokens, max_new, kv_quant=False), i


def test_front_door_rejections(servers):
    answers = []
    for srv in servers:
        got = [post(srv.port, body)[::2] for body in (
            {"tokens": [1, 2, 3], "max_new": 1000},
            {"tokens": "nope", "max_new": 4}, {"max_new": 4},
            {"tokens": [1], "max_new": 0})]
        got.append(get(srv.port, "/nope"))
        answers.append(got)
        assert _healthz(srv.port)["ok"] is True
    got = _same(answers)
    assert [code for code, _ in got] == [400, 400, 400, 400, 404]
    assert "max_seq_len" in got[0][1]["error"]


def test_request_id_echoed_and_replay_deduped(servers):
    """A request_id is echoed on every chunk; re-sending it returns the
    same result, streamed or not, and the engine runs it once."""
    body = {"tokens": [3, 4, 5], "max_new": 6, "stream": True,
            "request_id": "idem-echo-1"}
    answers = []
    for srv in servers:
        code, _, lines = post(srv.port, body)
        assert code == 200 and lines[-1]["done"] is True
        assert all(ln["request_id"] == "idem-echo-1" for ln in lines)
        served = _healthz(srv.port)["served"]
        replay = post(srv.port, body)[2]
        code, _, out = post(srv.port, {**body, "stream": False})
        assert code == 200 and out["done"] is True
        assert out["request_id"] == "idem-echo-1"
        assert _healthz(srv.port)["served"] == served
        answers.append((tokens_of(lines), tokens_of(replay), out["tokens"]))
    first = _same(answers)[0]
    assert len(first) == 6 and first == solo([3, 4, 5], 6, kv_quant=False)
    assert _same(answers) == (first, first, first)


def test_requests_without_id_are_never_deduped(servers):
    for srv in servers:
        served = _healthz(srv.port)["served"]
        body = {"tokens": [7, 8], "max_new": 3, "stream": False}
        out1, out2 = post(srv.port, body)[2], post(srv.port, body)[2]
        assert out1["done"] and out2["done"] and "request_id" not in out1
        assert _healthz(srv.port)["served"] == served + 2


def test_request_id_rejected_when_malformed(servers):
    for srv in servers:
        for rid in (["not", "a", "string"], "x" * 200):
            code, _, body = post(srv.port, {"tokens": [1], "max_new": 1,
                                            "request_id": rid})
            assert code == 400 and "request_id" in body["error"]


def test_engine_survives_a_failed_round_and_reports_health(servers):
    """A failed round of the slot engine fails its in-flight request
    loudly (a final error line), /healthz records the error with the
    engine alive, and the next request decodes exactly."""
    answers = []
    for srv in servers:
        real_step = srv.pool.step_round
        boom = {"armed": True}

        def flaky_step(real_step=real_step, boom=boom):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected backend failure")
            return real_step()

        srv.pool.step_round = flaky_step
        try:
            lines = post(srv.port, {"tokens": [1, 2], "max_new": 4})[2]
            assert lines[-1]["done"] is True
            assert "injected backend failure" in lines[-1]["error"]
            h = _healthz(srv.port)
            assert h["ok"] is True
            assert "injected backend failure" in h["last_error"]
            answers.append(tokens_of(post(srv.port, {"tokens": [5, 6],
                                                     "max_new": 4})[2]))
        finally:
            srv.pool.step_round = real_step
    assert _same(answers) == solo([5, 6], 4, kv_quant=False)


def test_latency_telemetry_surfaces_in_healthz(servers):
    for srv in servers:
        served = _healthz(srv.port)["served"]
        for tokens, max_new in ([1, 2], 4), ([3], 6), ([2, 2, 2], 2):
            assert post(srv.port, {"tokens": tokens, "max_new": max_new,
                                   "stream": False})[0] == 200
        h = _healthz(srv.port)
        assert h["served"] == served + 3
        assert h["p50_ttft_ms"] > 0
        assert h["p50_total_ms"] >= h["p50_ttft_ms"]
        assert h["active"] == 0 and h["queued"] == 0
