"""A live mixed fleet: a ``router.FleetRouter``, the reference's unchanged
one or the port's (``tpu_bootstrap_torch.workload.router``; every test runs
behind each, ``router_pkg``), fronting one reference replica (``tpu_bootstrap.workload.ingress``) and
one port replica (``tpu_bootstrap_torch.workload.ingress``), both the
paged engine on an int8 KV pool over the f32 bridged int8 weights of
tests/test_torch_scheduler.py, everything on 127.0.0.1:0.

Held, across the two packages: placement by each replica's published
/cachez digest (a prompt warm on one replica lands there, cached), failover
when the chosen replica dies before its first token (the stream completes
on the survivor), and exactly-once execution of a re-sent ``request_id``
(the replica's idempotency record answers the retry, and the router's
own dispatch fault re-places a request once). Every stream equals solo
greedy ``generate``. The router scrapes on demand (``scrape_once``): its
loop's first scrape lands at start, the next an hour later."""

import pytest
import torch

from tests.test_torch_ingress import get, post, solo, tokens_of
from tests.test_torch_scheduler import JCFG, JPARAMS, TCFG, TPARAMS
from tpu_bootstrap.workload import faults as jfaults
from tpu_bootstrap.workload import ingress as jingress
from tpu_bootstrap.workload import router as jrouter
from tpu_bootstrap_torch.workload import faults as tfaults
from tpu_bootstrap_torch.workload import ingress as tingress
from tpu_bootstrap_torch.workload import router as trouter

torch.set_num_threads(2)

REPLICA = dict(port=0, batch_size=2, paged=True, kv_quant=True,
               block_size=8, host="127.0.0.1")
PROMPT = list(range(1, 18))  # two full blocks of 8
# Each router with the faults module whose seams it fires.
ROUTERS = {"ref": (jrouter, jfaults), "port": (trouter, tfaults)}


@pytest.fixture(scope="module")
def replicas():
    ref = jingress.IngressServer(JPARAMS, JCFG, **REPLICA).start()
    port = tingress.IngressServer(TPARAMS, TCFG, device="cpu",
                                  **REPLICA).start()
    yield ref, port
    ref.stop()
    port.stop()


@pytest.fixture(params=sorted(ROUTERS))
def router_pkg(request):
    mod, faults = ROUTERS[request.param]
    yield mod, faults
    faults.install(None)


def _router(mod, servers):
    return mod.FleetRouter([f"127.0.0.1:{s.port}" for s in servers], port=0,
                           host="127.0.0.1", scrape_s=3600.0, stale_s=3600.0,
                           breaker_s=0.2, hedge_s=0.0, timeout_s=60.0,
                           connect_timeout_s=2.0).start()


@pytest.fixture
def router(replicas, router_pkg):
    r = _router(router_pkg[0], replicas)
    yield r
    r.stop()


def _served(srv) -> int:
    return get(srv.port, "/healthz")[1]["served"]


def _warm(srv, tokens):
    code, _, out = post(srv.port, {"tokens": tokens, "max_new": 2,
                                   "stream": False})
    assert code == 200


@pytest.mark.parametrize("warm_on", ["port", "ref"])
def test_placement_by_digest_across_packages(replicas, router, router_pkg,
                                             warm_on):
    """A prompt warm on one replica (the other cold for it) is placed
    there by the router and served from its prefix cache."""
    ref, port = replicas
    target = port if warm_on == "port" else ref
    # A prompt of its own for each router and target, so no run finds it
    # warm on the other replica.
    shift = {(jrouter, "port"): 3, (jrouter, "ref"): 7,
             (trouter, "port"): 9, (trouter, "ref"): 14}[
        router_pkg[0], warm_on]
    tokens = [t + shift for t in PROMPT]
    _warm(target, tokens)
    router.scrape_once()
    before = [_served(s) for s in replicas]
    code, _, out = post(router.port, {"tokens": tokens, "max_new": 5,
                                      "stream": False})
    assert code == 200 and out["done"] is True
    assert out["cached_tokens"] == 16
    assert out["tokens"] == solo(tokens, 5)
    after = [_served(s) for s in replicas]
    hit = 1 if warm_on == "port" else 0
    assert after[hit] == before[hit] + 1
    assert after[1 - hit] == before[1 - hit]


def test_failover_when_the_chosen_replica_dies_before_its_first_token(
        router_pkg):
    """The digest points at the port replica; it is gone when the request
    arrives (connection refused): the router re-places it on the
    reference replica, and the client sees one complete stream."""
    ref = jingress.IngressServer(JPARAMS, JCFG, **REPLICA).start()
    port = tingress.IngressServer(TPARAMS, TCFG, device="cpu",
                                  **REPLICA).start()
    r = _router(router_pkg[0], (ref, port))
    try:
        tokens = [t + 11 for t in PROMPT]
        _warm(port, tokens)
        r.scrape_once()
        port.stop()
        code, _, lines = post(r.port, {"tokens": tokens, "max_new": 4})
        assert code == 200
        assert lines[-1].get("done") is True and not lines[-1].get("error")
        assert tokens_of(lines) == solo(tokens, 4)
        assert r.reg.to_json().get("fleet_route_failovers_total", 0) == 1
        assert _served(ref) == 1
    finally:
        r.stop()
        ref.stop()


def test_resent_request_id_executes_once(replicas, router, router_pkg):
    """The same request_id twice through the router: one execution (the
    replica's idempotency record replays it), the same tokens."""
    tokens = [t + 13 for t in PROMPT]
    body = {"tokens": tokens, "max_new": 4, "stream": False,
            "request_id": f"fleet-idem-{router_pkg[0].__name__}"}
    before = sum(_served(s) for s in replicas)
    first = post(router.port, body)[2]
    router.scrape_once()
    again = post(router.port, body)[2]
    assert first["tokens"] == again["tokens"] == solo(tokens, 4)
    assert again["request_id"] == body["request_id"]
    assert sum(_served(s) for s in replicas) == before + 1


def test_dispatch_fault_fails_over_exactly_once(replicas, router,
                                                router_pkg):
    """router.dispatch: the first leg dies before reaching any replica;
    the request re-places with the same key and runs once."""
    faults = router_pkg[1]
    tokens = [t + 5 for t in PROMPT]
    before = sum(_served(s) for s in replicas)
    faults.install("router.dispatch:1:0")
    lines = post(router.port, {"tokens": tokens, "max_new": 3,
                               "request_id": "fleet-f1-"
                               + router_pkg[0].__name__})[2]
    faults.install(None)
    assert lines[-1].get("done") is True and not lines[-1].get("error")
    assert tokens_of(lines) == solo(tokens, 3)
    assert sum(_served(s) for s in replicas) == before + 1
    assert router.reg.to_json().get("fleet_route_failovers_total", 0) == 1
