"""Operational HTTP gateway (counterpart of ``raft_tpu.obs.gateway``): the
obs pull surface, reachable over TCP.

Every scrape / probe / debug answer of the obs package is a lock-light pull
API — ``to_prometheus()``, ``SearchService.healthz()`` / ``readyz()``,
``obs.snapshot()``, the incident / flight / explain / perf exports.
:class:`OperationalGateway` serves them over HTTP, stdlib only
(``http.server``): owned by ``SearchService(gateway=...)``, or standalone
(``python -m raft_tpu_torch.obs.gateway --port N`` over the process-default
registries).

Read plane (GET):

- ``/metrics`` — Prometheus text 0.0.4, or OpenMetrics 1.0.0 with
  exemplars when the ``Accept`` header negotiates it
  (:func:`raft_tpu_torch.obs.export.negotiate_content_type`);
- ``/healthz`` — the full health report; HTTP 503 only on an
  ``UNHEALTHY`` verdict (liveness keeps answering while DEGRADED);
- ``/readyz`` — the traffic gate; 503 until every served index's
  bucket ladder is warm (and always 503 with no service attached);
- ``/snapshot`` — ``SearchService.metrics()`` (or the bare registry
  snapshot standalone);
- ``/slo`` ``/autotune`` ``/perf/hotspots`` ``/incidents[/<id>]``
  ``/flight`` — the corresponding subsystem snapshots;
- ``/explain?name=<index>&q=<v0,v1,...>`` — a deep EXPLAIN of one request
  through the live batched path (needs an attached service).

Admin plane (POST, off by default): enabled by ``RAFT_TPU_GATEWAY_ADMIN``
and guarded by a mandatory ``RAFT_TPU_GATEWAY_TOKEN`` bearer check —
admin on with no token refuses with 403 (fail closed), and with the plane
off the routes 404 as if they did not exist.  ``/admin/compact?name=``,
``/admin/effort_pin?name=&level=`` (a negative level clears the pin),
``/admin/flight_dump``, ``/admin/archive_dump``.

Design constraints, in order: the server never touches the serve hot path
(it calls only the pull APIs, takes no serve lock of its own and adds no
clock read to a dispatch); it is bounded (a fixed worker pool serves
requests: a scrape storm queues at accept(), it spawns no threads); and it
observes itself — ``raft_tpu_gateway_requests_total{route,code}`` counts
every answer by matched route pattern (bounded label cardinality).
"""

from __future__ import annotations

import hmac
import json
import socketserver
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from raft_tpu_torch.core import env as _env
from raft_tpu_torch.core.trace import traced
from raft_tpu_torch.obs import export as _export
from raft_tpu_torch.obs import flight as _flight
from raft_tpu_torch.obs import health as _health
from raft_tpu_torch.obs import incidents as _incidents
from raft_tpu_torch.obs import perf as _perf
from raft_tpu_torch.obs.registry import MetricsRegistry, default_registry

JSON_CONTENT_TYPE = "application/json; charset=utf-8"

#: dispatch result: (status, content type, body, extra headers)
_Answer = Tuple[int, str, bytes, Optional[Dict[str, str]]]


@dataclass(frozen=True)
class GatewayConfig:
    """Bind/auth knobs for one :class:`OperationalGateway`.

    ``port=0`` binds an ephemeral port (read it back from
    :attr:`OperationalGateway.port`) — the test/bench default, so
    parallel processes never fight over a listener.
    """

    host: str = "127.0.0.1"
    port: int = 0
    admin: bool = False
    token: Optional[str] = None
    max_workers: int = 4

    @classmethod
    def from_env(cls) -> "GatewayConfig":
        return cls(
            port=_env.env_int("RAFT_TPU_GATEWAY_PORT", 0),
            admin=_env.env_bool("RAFT_TPU_GATEWAY_ADMIN", False),
            token=_env.env_str("RAFT_TPU_GATEWAY_TOKEN"),
        )


class _Handler(BaseHTTPRequestHandler):
    """Thin adapter: parse the request line, hand off to the gateway's
    :meth:`OperationalGateway.dispatch`, write the answer back."""

    server_version = "raft-tpu-gateway"
    # HTTP/1.0 closes per response: scrapers reconnect per scrape and a
    # drain never waits on an idle keep-alive connection
    protocol_version = "HTTP/1.0"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # the request counter is the access log

    def do_GET(self):  # noqa: N802 — stdlib dispatch name
        self._answer("GET")

    def do_POST(self):  # noqa: N802
        self._answer("POST")

    def _answer(self, method: str) -> None:
        gateway = self.server.gateway  # type: ignore[attr-defined]
        parsed = urlparse(self.path)
        query = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
        status, ctype, body, extra = gateway.dispatch(
            method, parsed.path, query, self.headers
        )
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for key, value in (extra or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # client hung up mid-answer; nothing to salvage


class _GatewayServer(socketserver.ThreadingMixIn, HTTPServer):
    """HTTPServer whose connections run on a *bounded* pool.

    ``ThreadingMixIn`` is in the MRO for its shutdown bookkeeping, but
    ``process_request`` is overridden to submit to a fixed
    ``ThreadPoolExecutor`` instead of spawning a thread per connection —
    a scrape storm queues inside the executor rather than growing
    unbounded threads, and ``close()`` can drain in-flight responses
    with one ``shutdown(wait=True)``.
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, address, gateway: "OperationalGateway",
                 max_workers: int):
        super().__init__(address, _Handler)
        self.gateway = gateway
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, int(max_workers)),
            thread_name_prefix="raft-tpu-gateway",
        )

    def process_request(self, request, client_address):
        try:
            self._pool.submit(self._work, request, client_address)
        except RuntimeError:
            # pool already shut down: a connection raced the close —
            # refuse it instead of serving off a dying server
            self.shutdown_request(request)

    def _work(self, request, client_address):
        try:
            self.finish_request(request, client_address)
        except Exception:  # noqa: BLE001 — stdlib handle_error contract
            self.handle_error(request, client_address)
        finally:
            self.shutdown_request(request)

    def drain(self) -> None:
        """Block until every in-flight response has been written."""
        self._pool.shutdown(wait=True)


class OperationalGateway:
    """The operational HTTP server over the obs pull surface.

    Parameters
    ----------
    service:
        The live ``SearchService`` to answer for, or ``None`` for a
        standalone gateway over the process-default registries (then
        ``/readyz`` is always 503 and ``/explain`` 404s — there is no
        serving process to gate or replay through).
    config:
        Bind/auth knobs; default :meth:`GatewayConfig.from_env`.
    registry:
        Metrics registry for the gateway's own request counter (default:
        the process registry — the one ``/metrics`` scrapes, so the
        gateway's traffic rides the same document).
    """

    def __init__(self, service=None, *,
                 config: Optional[GatewayConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.service = service
        self.config = config if config is not None else \
            GatewayConfig.from_env()
        reg = registry if registry is not None else default_registry()
        self._requests = reg.counter(
            "raft_tpu_gateway_requests_total",
            help="gateway HTTP requests by matched route and status code",
        )
        self._lock = threading.Lock()
        self._server: Optional[_GatewayServer] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # route table: matched pattern -> (method, handler).  The pattern
        # string is also the counter's route label — bounded cardinality
        # by construction (raw paths never become labels).
        self._routes: Dict[str, Tuple[str, Callable]] = {
            "/metrics": ("GET", self._r_metrics),
            "/healthz": ("GET", self._r_healthz),
            "/readyz": ("GET", self._r_readyz),
            "/snapshot": ("GET", self._r_snapshot),
            "/slo": ("GET", self._r_slo),
            "/perf/hotspots": ("GET", self._r_hotspots),
            "/incidents": ("GET", self._r_incidents),
            "/incidents/<id>": ("GET", self._r_incident),
            "/flight": ("GET", self._r_flight),
            "/explain": ("GET", self._r_explain),
            "/autotune": ("GET", self._r_autotune),
            "/admin/compact": ("POST", self._r_admin_compact),
            "/admin/effort_pin": ("POST", self._r_admin_effort_pin),
            "/admin/flight_dump": ("POST", self._r_admin_flight_dump),
            "/admin/archive_dump": ("POST", self._r_admin_archive_dump),
        }

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "OperationalGateway":
        """Bind and serve on a background accept thread.  Idempotent.
        Raises ``OSError`` when the configured port cannot be bound."""
        with self._lock:
            if self._server is not None or self._closed:
                return self
            cfg = self.config
            server = _GatewayServer(
                (cfg.host, cfg.port), self, cfg.max_workers
            )
            thread = threading.Thread(
                target=server.serve_forever,
                kwargs={"poll_interval": 0.05},
                name="raft-tpu-gateway-accept",
                daemon=True,
            )
            self._server, self._thread = server, thread
            thread.start()
        return self

    def close(self) -> None:
        """Stop accepting, drain in-flight responses, release the port.
        Idempotent; safe to call on a never-started gateway."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            server, thread = self._server, self._thread
            self._server = self._thread = None
        if server is None:
            return
        server.shutdown()  # stops the accept loop
        if thread is not None:
            thread.join(timeout=10.0)
        server.drain()  # waits for every submitted response to finish
        server.server_close()

    @property
    def port(self) -> Optional[int]:
        """The bound port (the real one when config.port was 0), or
        ``None`` before :meth:`start`."""
        with self._lock:
            return self._server.server_address[1] if self._server else None

    @property
    def url(self) -> Optional[str]:
        with self._lock:
            if self._server is None:
                return None
            host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def __enter__(self) -> "OperationalGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatch --------------------------------------------------------

    @traced("gateway.request")
    def dispatch(self, method: str, path: str, query: Dict[str, str],
                 headers) -> _Answer:
        """Route one request and count the answer.  Never raises — an
        unexpected handler error becomes a 500 with the error text, so
        the process keeps serving scrapes through its own bugs."""
        route, answer = "unknown", None
        try:
            match = self._match(path)
            if match is None:
                answer = _json_error(404, "no such route")
            else:
                route, allowed, handler, arg = match
                if method != allowed:
                    answer = _json_error(
                        405, f"method {method} not allowed",
                        extra={"Allow": allowed},
                    )
                elif route.startswith("/admin/"):
                    answer = self._authorize(headers) or \
                        handler(query, arg, headers)
                else:
                    answer = handler(query, arg, headers)
        except Exception as exc:  # noqa: BLE001 — keep the server up
            answer = _json_error(500, f"internal error: {exc!r}")
        self._requests.inc(route=route, code=str(answer[0]))
        return answer

    def _match(self, path: str):
        """Resolve ``path`` to ``(pattern, method, handler, arg)``."""
        entry = self._routes.get(path)
        if entry is not None:
            return path, entry[0], entry[1], None
        if path.startswith("/incidents/"):
            incident_id = path[len("/incidents/"):]
            if incident_id and "/" not in incident_id:
                method, handler = self._routes["/incidents/<id>"]
                return "/incidents/<id>", method, handler, incident_id
        return None

    def _authorize(self, headers) -> Optional[_Answer]:
        """Admin-plane gate: ``None`` admits, an answer refuses."""
        cfg = self.config
        if not cfg.admin:
            # plane off: indistinguishable from a route that never existed
            return _json_error(404, "no such route")
        if not cfg.token:
            return _json_error(
                403, "admin plane enabled but RAFT_TPU_GATEWAY_TOKEN is "
                     "not configured; refusing all admin requests",
            )
        supplied = (headers.get("Authorization") or "").strip()
        expected = f"Bearer {cfg.token}"
        if not hmac.compare_digest(supplied, expected):
            return _json_error(
                401, "missing or invalid bearer token",
                extra={"WWW-Authenticate": "Bearer"},
            )
        return None

    # -- read plane ------------------------------------------------------

    def _r_metrics(self, query, arg, headers) -> _Answer:
        ctype = _export.negotiate_content_type(headers.get("Accept"))
        openmetrics = ctype == _export.OPENMETRICS_CONTENT_TYPE
        if self.service is not None:
            # the service's scrape path refreshes pull gauges first
            text = (self.service.openmetrics() if openmetrics
                    else self.service.prometheus())
        else:
            text = (_export.to_openmetrics() if openmetrics
                    else _export.to_prometheus())
        return 200, ctype, text.encode("utf-8"), None

    def _r_healthz(self, query, arg, headers) -> _Answer:
        if self.service is not None:
            report = self.service.healthz()
        else:
            # standalone: no served indexes to probe, but the device
            # memory check and the overall verdict machinery still apply
            report = _health.build_report({})
        status = 503 if report.get("status") == _health.UNHEALTHY else 200
        return _json_answer(status, report)

    def _r_readyz(self, query, arg, headers) -> _Answer:
        if self.service is None:
            return _json_answer(
                503, {"ready": False, "reason": "no service attached"}
            )
        report = self.service.readyz()
        return _json_answer(200 if report.get("ready") else 503, report)

    def _r_snapshot(self, query, arg, headers) -> _Answer:
        if self.service is not None:
            return _json_answer(200, self.service.metrics())
        return _json_answer(200, default_registry().snapshot())

    def _r_slo(self, query, arg, headers) -> _Answer:
        engine = getattr(self.service, "slo_engine", None)
        if engine is None:
            return _json_error(404, "no SLO engine configured")
        return _json_answer(200, engine.snapshot())

    def _r_hotspots(self, query, arg, headers) -> _Answer:
        try:
            n = max(1, min(int(query.get("n", "8")), 64))
        except ValueError:
            return _json_error(400, "n must be an integer")
        return _json_answer(
            200, {"hotspots": _perf.default_ledger().top_hotspots(n)}
        )

    def _r_incidents(self, query, arg, headers) -> _Answer:
        return _json_answer(200, _incidents.default_manager().snapshot())

    def _r_incident(self, query, incident_id, headers) -> _Answer:
        manager = _incidents.default_manager()
        for incident in (
            list(manager.open_incidents()) + list(manager.closed_incidents())
        ):
            # ids are ints, the path's is text (raft_tpu compares the two
            # as they are, so its route never finds an incident)
            if str(incident.id) == incident_id:
                return _json_answer(200, incident.to_dict())
        return _json_error(404, f"no incident {incident_id!r}")

    def _r_flight(self, query, arg, headers) -> _Answer:
        return _json_answer(200, _flight.flight_snapshot())

    def _r_explain(self, query, arg, headers) -> _Answer:
        if self.service is None:
            return _json_error(404, "explain needs an attached service")
        name, raw = query.get("name"), query.get("q")
        if not name or not raw:
            return _json_error(400, "explain needs name= and q= "
                                    "(comma-separated floats)")
        try:
            vector = [float(x) for x in raw.split(",") if x.strip()]
        except ValueError:
            return _json_error(400, "q must be comma-separated floats")
        if name not in set(self.service.names()):
            return _json_error(404, f"no index {name!r}")
        import numpy as np  # deferred: keep module import light
        try:
            plan = self.service.explain(
                name, np.asarray(vector, dtype=np.float32), timeout=30.0
            )
        except RuntimeError as exc:  # obs pipeline off
            return _json_error(503, str(exc))
        except ValueError as exc:  # wrong dimensionality etc.
            return _json_error(400, str(exc))
        return _json_answer(200, plan.to_dict())

    def _r_autotune(self, query, arg, headers) -> _Answer:
        tuner = getattr(self.service, "autotuner", None)
        if tuner is None:
            return _json_error(404, "no autotuner configured")
        body = tuner.snapshot()
        if self.service is not None:
            # fold in the live arbitrated levels — the snapshot's view is
            # the tuner's intent, the arbiter's is what dispatch uses
            efforts = {}
            for name in self.service.names():
                arbiter = self.service.effort_arbiter(name)
                if arbiter is not None:
                    efforts[name] = arbiter.snapshot()
            body["effort"] = efforts
        return _json_answer(200, body)

    # -- admin plane -----------------------------------------------------

    def _r_admin_compact(self, query, arg, headers) -> _Answer:
        if self.service is None:
            return _json_error(404, "no service attached")
        name = query.get("name")
        if not name:
            return _json_error(400, "compact needs name=")
        if name not in set(self.service.names()):
            return _json_error(404, f"no index {name!r}")
        try:
            return _json_answer(200, self.service.compact_now(name))
        except RuntimeError as exc:  # no compactor configured
            return _json_error(409, str(exc))

    def _r_admin_effort_pin(self, query, arg, headers) -> _Answer:
        if self.service is None:
            return _json_error(404, "no service attached")
        name = query.get("name")
        if not name:
            return _json_error(400, "effort_pin needs name= and level=")
        if name not in set(self.service.names()):
            return _json_error(404, f"no index {name!r}")
        arbiter = self.service.effort_arbiter(name)
        if arbiter is None:
            return _json_error(
                409, f"index {name!r} has no effort arbiter (service "
                     "runs without overload or autotune)",
            )
        try:
            level = int(query.get("level", ""))
        except ValueError:
            return _json_error(400, "level must be an integer "
                                    "(negative clears the pin)")
        pinned = arbiter.set_pin(None if level < 0 else level)
        return _json_answer(
            200, {"name": name, "pinned": pinned, **arbiter.snapshot()}
        )

    def _r_admin_flight_dump(self, query, arg, headers) -> _Answer:
        path = _flight.dump(reason="gateway_admin")
        return _json_answer(200, {"path": path})

    def _r_admin_archive_dump(self, query, arg, headers) -> _Answer:
        from raft_tpu_torch.obs import explain as _explain
        path = _explain.dump(reason="gateway_admin")
        return _json_answer(200, {"path": path})


def _json_answer(status: int, payload) -> _Answer:
    body = json.dumps(payload, default=str).encode("utf-8")
    return status, JSON_CONTENT_TYPE, body, None


def _json_error(status: int, message: str,
                extra: Optional[Dict[str, str]] = None) -> _Answer:
    body = json.dumps({"error": message}).encode("utf-8")
    return status, JSON_CONTENT_TYPE, body, extra


def main(argv=None, *, ready=None) -> int:
    """``python -m raft_tpu_torch.obs.gateway --port N`` — standalone gateway.

    Serves the process-default registries (useful for a sidecar-style
    debug process, or any embedder that builds indexes without a
    ``SearchService``).  Exits 1 when the port cannot be bound; SIGTERM
    and SIGINT close the listener and drain in-flight responses before
    the process exits (``ready``, test hook: called with the started
    gateway and the stop event).
    """
    import argparse
    import signal
    import sys

    parser = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.obs.gateway",
        description="standalone raft_tpu_torch operational HTTP gateway",
    )
    parser.add_argument("--port", type=int, default=None,
                        help="listen port (default RAFT_TPU_GATEWAY_PORT)")
    parser.add_argument("--host", default=None,
                        help="bind address (default 127.0.0.1)")
    parser.add_argument("--admin", action="store_true",
                        help="enable the POST /admin plane (still needs "
                             "RAFT_TPU_GATEWAY_TOKEN)")
    args = parser.parse_args(argv)

    config = GatewayConfig.from_env()
    if args.port is not None:
        config = replace(config, port=args.port)
    if args.host is not None:
        config = replace(config, host=args.host)
    if args.admin:
        config = replace(config, admin=True)

    gateway = OperationalGateway(config=config)
    try:
        gateway.start()
    except OSError as exc:
        print(f"raft-tpu-gateway: bind {config.host}:{config.port} "
              f"failed: {exc}", file=sys.stderr)
        return 1

    stop = threading.Event()

    def _terminate(signum, frame):
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _terminate)
        signal.signal(signal.SIGINT, _terminate)
    except ValueError:
        pass  # not the main thread (embedded/test use): caller stops us

    print(f"raft-tpu-gateway: serving {gateway.url}", file=sys.stderr)
    if ready is not None:
        ready(gateway, stop)
    stop.wait()
    gateway.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
