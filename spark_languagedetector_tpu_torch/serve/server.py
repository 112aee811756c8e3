"""Stdlib-only HTTP front end for the serving subsystem.

Port of ``spark_languagedetector_tpu.serve.server``, with the same routes
and wire format. A threaded ``http.server`` speaking JSON: the batcher
already puts all device work on one thread, so the HTTP layer only has to
block cheaply.

Endpoints:

  * ``POST /score``   ``{"texts": [...], "priority"?, "deadline_ms"?,
    "trace_id"?, "tenant"?}`` → ``{"scores": [[...]], "version",
    "trace_id", ...}``
  * ``POST /detect``  same request → ``{"labels": [...], ...}``;
    ``?mode=segment`` (or a body ``"mode"``, or a model whose
    ``resultMode`` is ``"segment"``) → ``{"results": [...], "mode":
    "segment", ...}``, with optional ``top_k``/``reject_threshold``
  * ``GET  /healthz`` combined snapshot (readiness, queue, breaker,
    version); ``/healthz/live`` liveness only; ``/healthz/ready`` 200 only
    when this server should receive traffic (503 with ``reasons`` while
    draining, the breaker is not closed, the ladder is active or no model
    is installed)
  * ``GET  /varz`` stage summaries, counters, gauges, histograms, versions,
    cache stats and the effective config; ``GET /telemetryz`` the
    mergeable registry snapshot stamped with the process identity
  * ``POST /admin/swap`` ``{"path": "<model dir>", "version"?,
    "tenant"?}`` → hot swap; ``POST /admin/rollback`` → previous version

Backed by a :class:`~..zoo.ModelZoo`, a request's ``"tenant"`` (absent:
the zoo's default tenant) picks that tenant's registry and batcher, and
responses carry the ``tenant``; a single-model server answers 400 to an
explicit tenant.

Failure mapping: a shed answers 503 with ``Retry-After``, a blown
deadline 504, a quarantined query of death 422, a bad request 400, a
dispatch error 500 with the error (a kernel failure by its
``KernelBuildError``/``KernelLaunchError`` name); never a hang, and never a
batch scored elsewhere than its runner's device. A replica's own error
surfacing through the fleet router keeps its status and body.

Texts are encoded server-side with the active model's ``predictEncoding``
param, as ``model.transform`` would.

    python -m spark_languagedetector_tpu_torch.serve.server <model_dir> [host:port]

serves a saved model on the CUDA card (and raises without one).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..exec import config as exec_config
from ..ops.encoding import UTF8, text_to_bytes
from ..segment import SegmentOptions
from ..telemetry import REGISTRY
from ..telemetry.aggregate import install_process_identity, process_identity
from ..utils.logging import get_logger, log_event
from .batcher import (
    LANES,
    ContinuousBatcher,
    ServeClosed,
    ServeDeadlineExceeded,
    ServeError,
    ServeOverloaded,
)
from .client import ServeHTTPError
from .quarantine import QueryQuarantined
from .registry import ModelRegistry

_log = get_logger("serve.server")

MAX_BODY_BYTES = 64 << 20  # one request can still carry a bulk doc list
DRAIN_TIMEOUT_S = 30.0  # stop() waits this long for accepted requests


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "langdetect-serve"

    def log_message(self, fmt, *args):  # access logs go to our logger
        _log.debug("%s %s", self.address_string(), fmt % args)

    def _reply(self, status: int, payload: dict, headers: dict | None = None):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            raise ValueError(f"request body too large ({length} bytes)")
        raw = self.rfile.read(length) if length else b""
        payload = json.loads(raw.decode("utf-8")) if raw else {}
        if not isinstance(payload, dict):
            raise ValueError("request body must be a JSON object")
        return payload

    def do_GET(self):
        try:
            if self.path == "/healthz":
                self._reply(200, self.server.healthz())
            elif self.path == "/healthz/live":
                self._reply(200, self.server.livez())
            elif self.path == "/healthz/ready":
                payload = self.server.readyz()
                # A not-ready server answers its probe (it is live), with
                # 503 so plain load balancers drop it too.
                self._reply(200 if payload.get("ready") else 503, payload)
            elif self.path == "/varz":
                self._reply(200, self.server.varz())
            elif self.path == "/telemetryz":
                self._reply(200, self.server.telemetryz())
            else:
                self._reply(404, {"error": f"unknown path {self.path!r}"})
        except Exception as e:  # never let a probe kill the connection
            self._reply(500, {"error": repr(e)})

    def do_POST(self):
        # Tracked so stop() can drain: an accepted request is answered
        # before the batcher is torn down.
        with self.server.track_request():
            self._do_post_tracked()

    def _do_post_tracked(self):
        try:
            payload = self._read_json()
        except json.JSONDecodeError as e:  # before ValueError: its subclass
            self._reply(400, {"error": f"bad JSON: {e}"})
            return
        except ValueError as e:
            self._reply(400, {"error": str(e)})
            return
        try:
            parts = urlsplit(self.path)
            route = parts.path
            query = {k: v[-1] for k, v in parse_qs(parts.query).items()}
            if route == "/score":
                self._reply(200, self.server.score(payload, labels=False))
            elif route == "/detect":
                mode = query.get("mode", payload.get("mode"))
                self._reply(200, self.server.score(payload, labels=True, mode=mode))
            elif route == "/admin/swap":
                self._reply(200, self.server.swap(payload))
            elif route == "/admin/rollback":
                self._reply(200, self.server.rollback(payload))
            else:
                self._reply(404, {"error": f"unknown path {self.path!r}"})
        except ServeOverloaded as e:
            self._reply(
                503,
                {"error": str(e), "shed": True, "reason": e.reason},
                {"Retry-After": f"{max(e.retry_after_s, 0.001):.3f}"},
            )
        except ServeDeadlineExceeded as e:
            self._reply(504, {"error": str(e), "deadline": True})
        except ServeClosed as e:
            self._reply(503, {"error": str(e), "closed": True})
        except ServeHTTPError as e:
            # A replica's answer surfacing through the router front (a 400
            # or 504 the router does not retry): same status, body and
            # Retry-After as the replica gave.
            payload = e.payload if isinstance(e.payload, dict) else {"error": str(e)}
            headers = {
                "Retry-After": v for k, v in (e.headers or {}).items()
                if k.lower() == "retry-after"
            }
            self._reply(e.status, payload, headers)
        except QueryQuarantined as e:  # before ValueError: its subclass
            self._reply(422, {"error": str(e), "quarantined": True, "signature": e.signature})
        except (ValueError, KeyError) as e:
            self._reply(400, {"error": repr(e)})
        except Exception as e:
            self._reply(500, {"error": repr(e)})


class JsonHTTPFront(ThreadingHTTPServer):
    """The JSON front end's lifecycle: daemon serve thread, in-flight
    request tracking and a draining ``stop()`` (readiness flips false, the
    listener stops accepting, accepted requests are answered, and only
    then is the backend torn down). Subclasses implement the handler
    surface (``score``/``swap``/``rollback``/``healthz``/``readyz``/
    ``varz``) and ``_teardown``."""

    daemon_threads = True
    thread_name = "serve-http"
    # Listen backlog: socketserver's default of 5 resets connections when
    # a burst of clients connects at once; a shed must be an explicit 503.
    request_queue_size = 128

    def __init__(self, host: str, port: int):
        self._started = time.monotonic()
        self._thread: threading.Thread | None = None
        self._draining = False
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        super().__init__((host, port), _Handler)

    @property
    def address(self) -> tuple[str, int]:
        return self.server_address[0], self.server_address[1]

    @property
    def draining(self) -> bool:
        return self._draining

    @contextmanager
    def track_request(self):
        """Count one in-flight HTTP request, so a draining stop knows when
        every accepted request has been answered."""
        with self._inflight_cv:
            self._inflight += 1
        try:
            yield
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def start(self):
        """Serve on a daemon thread; returns self (``with`` works too)."""
        self._thread = threading.Thread(
            target=self.serve_forever, name=self.thread_name, daemon=True
        )
        self._thread.start()
        log_event(_log, "serve.http.start", host=self.address[0], port=self.address[1])
        return self

    def stop(self, *, drain: bool = True, drain_timeout_s: float = DRAIN_TIMEOUT_S):
        """Stop serving: readiness flips false, the listener stops
        accepting, and with ``drain`` every accepted request is answered
        (bounded by ``drain_timeout_s``) before the backend is torn down.
        ``drain=False`` is an abrupt death: queued requests fail at once
        with 503 (``ServeClosed``), never hang."""
        self._draining = True
        self.shutdown()
        if drain:
            deadline = time.monotonic() + drain_timeout_s
            with self._inflight_cv:
                while self._inflight > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        log_event(
                            _log, "serve.http.drain_timeout",
                            inflight=self._inflight, port=self.address[1],
                        )
                        break
                    self._inflight_cv.wait(min(remaining, 0.2))
        self._teardown(drain)
        self.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        log_event(_log, "serve.http.stop", port=self.address[1], drained=drain)

    def _teardown(self, drain: bool) -> None:  # subclass hook
        pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def telemetryz(self) -> dict:
        """The process registry's mergeable snapshot, stamped with this
        process's identity."""
        snap = REGISTRY.mergeable_snapshot()
        if not snap.get("identity"):
            snap["identity"] = process_identity()
        return snap

    def livez(self) -> dict:
        """Liveness: answering at all is the signal; the body is detail."""
        return {
            "live": True,
            "draining": self._draining,
            "uptime_s": round(time.monotonic() - self._started, 3),
        }


class ServingServer(JsonHTTPFront):
    """HTTP front end bound to a registry and a batcher, or to a model zoo.

    ``registry`` may be a :class:`~.registry.ModelRegistry`, a
    ``LanguageDetectorModel`` (installed into a fresh registry on the
    model's own device) or a :class:`~..zoo.ModelZoo`, whose tenants bring
    their own registries and batchers. Otherwise the server's batcher is
    ``batcher``, or one built from env-tuned knobs and the explicit ones in
    ``batcher_kw``. ``port=0`` binds an ephemeral port.
    """

    def __init__(
        self,
        registry,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
        batcher: ContinuousBatcher | None = None,
        **batcher_kw,
    ):
        self.zoo = None
        self.registry = None
        self.batcher = None
        self._own_batcher = False
        if hasattr(registry, "runtime") and hasattr(registry, "tenants"):
            self.zoo = registry  # a ModelZoo, duck-typed: serve never imports zoo
        else:
            if not hasattr(registry, "lease"):
                model = registry
                registry = ModelRegistry(device=model.get("device"))
                registry.install(model)
            self.registry = registry
            self._own_batcher = batcher is None
            self.batcher = batcher or ContinuousBatcher(registry, **batcher_kw)
        super().__init__(host, port)

    def _teardown(self, drain: bool) -> None:
        if self.zoo is not None:
            self.zoo.close(drain=drain)
        elif self._own_batcher:
            self.batcher.close(drain=drain)

    # ---------------------------------------------------------- handlers ----
    def _route(self, payload: dict):
        """(registry, batcher, tenant name or None) of one request. A
        single-model server refuses an explicit tenant (400); on a zoo no
        tenant means the default one, an unknown tenant is a 400 and a
        failed cold load that tenant's 503."""
        tenant = payload.get("tenant")
        if self.zoo is None:
            if tenant is not None:
                raise ValueError('"tenant" requires a model-zoo-backed server')
            return self.registry, self.batcher, None
        entry, rt = self.zoo.runtime(tenant)
        return rt.registry, rt.batcher, entry.name

    @staticmethod
    def _segment_options(payload: dict, model) -> SegmentOptions:
        """The decode knobs of one segment request: body keys (``top_k``,
        ``reject_threshold``) win, then the active model's ``topK``/
        ``rejectThreshold``. A bad knob is a 400, never a dispatch."""
        top_k = payload.get("top_k")
        reject = payload.get("reject_threshold")
        if top_k is None:
            top_k = model.get("topK")
        if reject is None:
            reject = model.get("rejectThreshold")
        if not isinstance(top_k, int) or isinstance(top_k, bool):
            raise ValueError(f'"top_k" must be an integer, got {top_k!r}')
        if not isinstance(reject, (int, float)) or isinstance(reject, bool):
            raise ValueError(f'"reject_threshold" must be a number, got {reject!r}')
        return SegmentOptions(top_k=int(top_k), reject_threshold=float(reject))

    def score(self, payload: dict, *, labels: bool, mode: str | None = None) -> dict:
        texts = payload.get("texts", payload.get("docs"))
        if not isinstance(texts, list) or not all(isinstance(t, str) for t in texts):
            raise ValueError('"texts" must be a list of strings')
        priority = payload.get("priority", "interactive")
        if priority not in LANES:
            raise ValueError(f"unknown priority {priority!r}; expected one of {LANES}")
        deadline_ms = payload.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
        want_mode = mode
        # On a zoo an eviction can close the tenant's batcher between the
        # route and the admission: route again (a cold load), at most three
        # times, so a server that is really closed still answers 503.
        for attempt in range(3):
            registry, batcher, tenant = self._route(payload)
            # Encoding and result mode are resolved at admission against
            # the active version: keep predictEncoding the same across
            # versions swapped under traffic.
            model = registry.peek().model
            encoding = model.get("predictEncoding") if model is not None else UTF8
            mode = want_mode
            if labels and mode is None and model is not None:
                mode = model.get("resultMode")
            if mode not in (None, "label", "segment"):
                raise ValueError(f"unknown mode {mode!r}; expected 'label' or 'segment'")
            segment_options = None
            if labels and mode == "segment":
                segment_options = self._segment_options(payload, model)
            docs = [text_to_bytes(t, encoding) for t in texts]
            try:
                result = batcher.submit(
                    docs, priority=priority,
                    want_labels=labels and segment_options is None,
                    segment_options=segment_options,
                    deadline_ms=deadline_ms,
                    trace_id=payload.get("trace_id"),
                ).result()
            except ServeClosed:
                if self.zoo is None or attempt == 2:
                    raise
                continue
            break
        timing = {
            "queue_wait_ms": round(result.queue_wait_s * 1e3, 3),
            "dispatch_ms": round(result.dispatch_s * 1e3, 3),
        }
        out = {
            "version": result.version,
            "trace_id": result.trace_id,
            **timing,
            "server_timing": {**timing, "rows_coalesced": result.rows_coalesced},
            "server": process_identity(),
        }
        if tenant is not None:
            out["tenant"] = tenant
        if segment_options is not None:
            out["mode"] = "segment"
            out["results"] = result.results
        elif labels:
            out["labels"] = result.labels
        else:
            # float() of a float32 is exact (f32 ⊂ f64) and JSON doubles
            # round-trip, so the wire is bit-transparent for scores.
            out["scores"] = [[float(v) for v in row] for row in result.values]
        return out

    def swap(self, payload: dict) -> dict:
        path = payload.get("path")
        if not isinstance(path, str) or not path:
            raise ValueError('"path" must name a saved model directory')
        tenant = payload.get("tenant")
        if self.zoo is not None:
            version = self.zoo.load(tenant, path, version=payload.get("version"))
            return {"version": version, "tenant": tenant or self.zoo.default_tenant}
        if tenant is not None:
            raise ValueError('"tenant" requires a model-zoo-backed server')
        return {"version": self.registry.load(path, version=payload.get("version"))}

    def rollback(self, payload: dict | None = None) -> dict:
        tenant = (payload or {}).get("tenant")
        if self.zoo is not None:
            return {
                "version": self.zoo.rollback(tenant),
                "tenant": tenant or self.zoo.default_tenant,
            }
        if tenant is not None:
            raise ValueError('"tenant" requires a model-zoo-backed server')
        return {"version": self.registry.rollback()}

    def readyz(self) -> dict:
        """Should this server receive traffic right now? Not while
        draining, while the runner's breaker is anything but closed or its
        ladder is active, or with no model installed."""
        reasons: list[str] = []
        version = None
        if self._draining:
            reasons.append("draining")
        if self.zoo is not None:
            # A zoo is ready once its default tenant is registered, resident
            # or not; per-tenant detail is in the healthz/varz zoo blocks.
            try:
                version = self.zoo.version(None)
            except ServeError:
                reasons.append("no_default_tenant")
            return {
                "ready": not reasons,
                "reasons": reasons,
                "version": version,
                "tenants": len(self.zoo.tenants()),
                "draining": self._draining,
            }
        try:
            entry = self.registry.peek()
            version = entry.version
            breaker = getattr(entry.runner, "breaker", None)
            state = breaker.state if breaker is not None else "closed"
            if state != "closed":
                reasons.append(f"breaker_{state}")
            if getattr(entry.runner, "_degraded_mode", False):
                reasons.append("degraded")
        except ServeError:
            reasons.append("no_model")
        return {
            "ready": not reasons,
            "reasons": reasons,
            "version": version,
            "draining": self._draining,
        }

    def healthz(self) -> dict:
        ready = self.readyz()
        out = {
            "ok": True,
            "ready": ready["ready"],
            "reasons": ready["reasons"],
            "draining": self._draining,
            "uptime_s": round(time.monotonic() - self._started, 3),
        }
        out["cache"] = self._cache_stats()
        if self.zoo is not None:
            out["zoo"] = self.zoo.healthz()
            return out
        out["batcher"] = self.batcher.stats()
        try:
            entry = self.registry.peek()
            out["version"] = entry.version
            out["languages"] = len(entry.languages or ())
            breaker = getattr(entry.runner, "breaker", None)
            out["breaker"] = breaker.state if breaker is not None else None
            out["degraded"] = bool(getattr(entry.runner, "_degraded_mode", False))
            out["device"] = str(getattr(entry.runner, "device", None))
        except ServeError as e:
            out["ok"] = False
            out["error"] = str(e)
        return out

    def varz(self) -> dict:
        snap = REGISTRY.snapshot()
        return {
            "stages": REGISTRY.stage_summary(),
            "counters": snap["counters"],
            "gauges": snap["gauges"],
            "histograms": {
                name: h for name, h in snap["histograms"].items()
                if not name.startswith(("span:", "span_device:"))
            },
            "versions": [] if self.registry is None else self.registry.versions(),
            "zoo": None if self.zoo is None else self.zoo.varz(),
            "cache": self._cache_stats(),
            # Every LANGDETECT_* knob's live value and provenance.
            "config": exec_config.effective_config(),
        }


    def _cache_stats(self):
        cache = self.zoo.cache if self.zoo is not None else self.batcher.cache
        return None if cache is None else cache.stats()


def main(argv: list[str] | None = None) -> int:
    """``python -m spark_languagedetector_tpu_torch.serve.server <model_dir>
    [host:port]``: load a saved model onto the CUDA card and serve it."""
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2 or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m spark_languagedetector_tpu_torch.serve.server "
            "<model_dir> [host:port]",
            file=sys.stderr,
        )
        return 2
    host, port = "127.0.0.1", 8000
    if len(argv) == 2:
        host, _, p = argv[1].rpartition(":")
        host = host or "127.0.0.1"
        port = int(p)
    registry = ModelRegistry()
    registry.load(argv[0])
    server = ServingServer(registry, host=host, port=port)
    install_process_identity(
        replica=f"{server.address[0]}:{server.address[1]}",
        device=registry.peek().runner.device,
    )
    print(f"serving {registry.current_version()} on {server.address[0]}:{server.address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
