"""Stdlib HTTP client for the serving front end.

Port of ``spark_languagedetector_tpu.serve.client``, with the same wire
format, so either package's client talks to either package's server. One
connection per call keeps the client thread-safe (concurrent callers share
one ``ServeClient``).

Non-2xx responses raise :class:`ServeHTTPError` carrying the status and
decoded body: a shed (503) or blown deadline (504) is an exception with
context, never a silent empty result.

Pass a :class:`~..resilience.policy.RetryPolicy` as ``retry_policy`` and the
idempotent calls (``score``/``detect``/``segment`` and every GET but the
probes) ride it: a 503 sleeps ``max(Retry-After, seeded-jitter backoff)``
and retries, bounded by ``max_attempts`` and, where the request carries
``deadline_ms``, by its deadline. With a
:class:`~..resilience.policy.RetryBudget` as ``retry_budget`` every success
deposits and every re-send withdraws a token, and an empty budget surfaces
the error. 400, 422 (a quarantined query of death) and 504 are never
retried; transport failures follow
:func:`~..resilience.policy.is_retryable`. Admin calls (``swap``/
``rollback``) never retry.

``tenant`` (on the client or per call) names a model zoo's tenant; unset,
the wire is the single-model one and a zoo answers from its default tenant.
"""

from __future__ import annotations

import json
import time
from http.client import HTTPConnection, HTTPException
from typing import Sequence

import numpy as np

from ..resilience.policy import RetryBudget, RetryPolicy, is_retryable
from ..telemetry import REGISTRY
from ..utils.logging import get_logger, log_event

_log = get_logger("serve.client")


class ServeHTTPError(RuntimeError):
    """Non-2xx response from the serving front end."""

    def __init__(self, status: int, payload: dict, headers: dict):
        super().__init__(f"HTTP {status}: {payload.get('error', payload)!r}")
        self.status = status
        self.payload = payload
        self.headers = headers

    @property
    def shed(self) -> bool:
        return bool(self.payload.get("shed"))

    @property
    def retry_after_s(self) -> float:
        try:
            return float(self.headers.get("Retry-After", 0.0))
        except ValueError:
            return 0.0


class ServeClient:
    """JSON client for one serving endpoint (host, port), optionally bound to
    a zoo ``tenant``."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        timeout_s: float = 60.0,
        retry_policy: RetryPolicy | None = None,
        retry_budget: RetryBudget | None = None,
        tenant: str | None = None,
    ):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.retry_policy = retry_policy
        self.retry_budget = retry_budget
        self.tenant = tenant

    # ------------------------------------------------------------- wire -----
    def _request_once(self, method: str, path: str, payload: dict | None = None):
        conn = HTTPConnection(self.host, self.port, timeout=self.timeout_s)
        try:
            body = None if payload is None else json.dumps(payload)
            headers = {"Content-Type": "application/json"} if body else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            raw = resp.read()
            data = json.loads(raw.decode("utf-8")) if raw else {}
            if not 200 <= resp.status < 300:
                raise ServeHTTPError(resp.status, data, dict(resp.getheaders()))
            return data
        finally:
            conn.close()

    @staticmethod
    def _retryable(exc: Exception) -> bool:
        """503 (shed or closed: the server asked for a later retry) and
        transport failures retry; 400, 422 and 504 never do."""
        if isinstance(exc, ServeHTTPError):
            return exc.status == 503
        return isinstance(exc, HTTPException) or is_retryable(exc)

    def _request(
        self,
        method: str,
        path: str,
        payload: dict | None = None,
        *,
        idempotent: bool | None = None,
        deadline_s: float | None = None,
    ):
        if idempotent is None:
            idempotent = method == "GET"
        policy = self.retry_policy
        budget = self.retry_budget
        attempt = 0
        while True:
            attempt += 1
            try:
                result = self._request_once(method, path, payload)
                if budget is not None:
                    budget.record_success()
                return result
            except Exception as e:
                if (
                    policy is None
                    or not idempotent
                    or not self._retryable(e)
                    or attempt >= policy.max_attempts
                ):
                    raise
                # The server's own estimate wins when it is longer than the
                # schedule; the seeded jitter de-synchronizes a herd.
                delay = policy.backoff_s(attempt)
                if isinstance(e, ServeHTTPError):
                    delay = max(delay, e.retry_after_s)
                if deadline_s is not None:
                    # A sleep that would end at or past the request's
                    # deadline buys a worthless retry: surface the error.
                    remaining = deadline_s - time.monotonic()
                    if remaining <= 0 or delay >= remaining:
                        REGISTRY.incr("serve/client_deadline_gaveups")
                        log_event(
                            _log, "serve.client.deadline_gaveup", path=path,
                            attempt=attempt, backoff_s=round(delay, 6),
                            remaining_s=round(remaining, 6),
                        )
                        raise
                if budget is not None and not budget.try_spend(reason="client_retry"):
                    raise
                REGISTRY.incr("serve/client_retries")
                log_event(
                    _log, "serve.client.retry", path=path, attempt=attempt,
                    max_attempts=policy.max_attempts, backoff_s=round(delay, 6),
                    error=repr(e),
                )
                if delay > 0:
                    time.sleep(delay)

    # -------------------------------------------------------------- api -----
    def _with_tenant(self, payload: dict, tenant: str | None) -> dict:
        tenant = self.tenant if tenant is None else tenant
        if tenant is not None:
            payload["tenant"] = tenant
        return payload

    def _post(self, path: str, payload: dict, deadline_ms, trace_id, tenant) -> dict:
        self._with_tenant(payload, tenant)
        deadline_s = None
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
            deadline_s = time.monotonic() + float(deadline_ms) / 1e3
        if trace_id is not None:
            payload["trace_id"] = trace_id
        return self._request("POST", path, payload, idempotent=True, deadline_s=deadline_s)

    def score(
        self,
        texts: Sequence[str],
        *,
        priority: str = "interactive",
        deadline_ms: float | None = None,
        trace_id: str | None = None,
        tenant: str | None = None,
    ) -> tuple[np.ndarray, dict]:
        """(float32 [N, L] scores, response metadata). The server sends each
        f32 as the exact double it widens to, and JSON doubles round-trip,
        so these scores equal the server-side arrays bit for bit."""
        data = self._post(
            "/score", {"texts": list(texts), "priority": priority}, deadline_ms, trace_id,
            tenant,
        )
        scores = np.asarray(data.pop("scores"), dtype=np.float32)
        if scores.size == 0:
            scores = scores.reshape(0, 0)
        return scores, data

    def detect(
        self,
        texts: Sequence[str],
        *,
        priority: str = "interactive",
        deadline_ms: float | None = None,
        trace_id: str | None = None,
        tenant: str | None = None,
    ) -> tuple[list, dict]:
        """(predicted labels, response metadata). A model whose
        ``resultMode`` is ``"segment"`` answers ``/detect`` with
        segmentation result dicts (``meta["mode"] == "segment"``)."""
        data = self._post(
            "/detect", {"texts": list(texts), "priority": priority}, deadline_ms, trace_id,
            tenant,
        )
        if "results" in data:
            return data.pop("results"), data
        return data.pop("labels"), data

    def segment(
        self,
        texts: Sequence[str],
        *,
        top_k: int | None = None,
        reject_threshold: float | None = None,
        priority: str = "interactive",
        deadline_ms: float | None = None,
        trace_id: str | None = None,
        tenant: str | None = None,
    ) -> tuple[list[dict], dict]:
        """(segmentation result dicts, response metadata) through
        ``/detect?mode=segment``. ``top_k``/``reject_threshold`` override
        the served model's params for this request only."""
        payload: dict = {"texts": list(texts), "priority": priority}
        if top_k is not None:
            payload["top_k"] = top_k
        if reject_threshold is not None:
            payload["reject_threshold"] = reject_threshold
        data = self._post("/detect?mode=segment", payload, deadline_ms, trace_id, tenant)
        return data.pop("results"), data

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def livez(self) -> dict:
        return self._request("GET", "/healthz/live")

    def readyz(self) -> dict:
        """The readiness payload, ready (200) or not (503): a not-ready
        server answering its probe is information, not an error. Never
        retried."""
        try:
            return self._request("GET", "/healthz/ready", idempotent=False)
        except ServeHTTPError as e:
            if e.status == 503 and isinstance(e.payload, dict):
                return e.payload
            raise

    def varz(self) -> dict:
        return self._request("GET", "/varz")

    def telemetryz(self) -> dict:
        """The server's mergeable telemetry snapshot. Never retried: a
        scrape wants the state now."""
        return self._request("GET", "/telemetryz", idempotent=False)

    def swap(self, path: str, *, version: str | None = None, tenant: str | None = None) -> str:
        payload: dict = {"path": path}
        if version is not None:
            payload["version"] = version
        self._with_tenant(payload, tenant)
        return self._request("POST", "/admin/swap", payload, idempotent=False)["version"]

    def rollback(self, *, tenant: str | None = None) -> str:
        payload = self._with_tenant({}, tenant) or None
        return self._request("POST", "/admin/rollback", payload, idempotent=False)["version"]
