"""Multi-process serving front end: N HTTP workers, one device-owning scorer
(port of photon_tpu/serve/frontend.py).

- **Workers** (N of them) accept connections on a SHARED listening socket,
  parse and validate HTTP and JSON, and forward each request over a
  Unix-domain socket to the scorer. They are spawned (never forked) and
  never initialise CUDA: no CUDA context is copied into a child.
- **Scorer** (exactly one, the parent) owns the card: admission →
  ``MicroBatcher`` → ``ServingEngine``, the path the in-process server
  uses. Requests from every worker co-batch in the one flusher, so the
  multi-process shape keeps the in-process engine's bit parity and its "no
  capture after warm-up" contract.

Wire protocol: a 4-byte big-endian length and UTF-8 JSON per frame, one
id-correlated request/response stream a worker connection; responses
complete out of order. Errors cross as ``{code, kind, error}`` and are
raised again client-side as the engine's exception types
(``QuotaExceededError``/``BackpressureError`` → 429,
``DeadlineExceededError`` → 504, ``ValueError`` → 400), so the HTTP layer
has one classification for both deployment shapes.

Every request carries a trace context: an HTTP ``traceparent`` header is
adopted (and forced into the flight recorder), else a root is minted; each
hop (HTTP handler, scorer, engine) records its span under it, and
``/v1/traces`` merges the kept trees of the worker and the scorer.
``/metrics`` is the Prometheus text of the registry (merged across the
worker and the scorer, labelled by replica). ``/v1/feedback`` completes
the engine's feedback-spool label join in both shapes. ``/v1/experiment``
is the manifest-derived experiment rollup of the publish root the engine
serves from, with the engine's live shadow lanes.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import logging
import os
import queue
import shutil
import socket
import socketserver
import struct
import tempfile
import threading
import time
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs

from photon_tpu_torch.obs.metrics import PROMETHEUS_CONTENT_TYPE, registry, render_prometheus
from photon_tpu_torch.obs.trace import (
    TraceContext,
    flight_recorder,
    merge_trace_dumps,
    mint_context,
    new_span_id,
    tracer,
)
from photon_tpu_torch.serve.admission import INTERACTIVE, PRIORITIES, QuotaExceededError
from photon_tpu_torch.serve.batcher import (
    BackpressureError,
    DeadlineExceededError,
    ScoreRequest,
)

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 64 << 20

# Shared secret for the TCP transport's HMAC handshake. Environment, never
# argv: command lines are world-readable via /proc.
FLEET_SECRET_ENV = "PHOTON_TPU_FLEET_SECRET"

# ---------------------------------------------------------------------------
# Request parsing + error classification (shared by both deployment shapes)
# ---------------------------------------------------------------------------


def request_from_json(obj: dict) -> ScoreRequest:
    if not isinstance(obj, dict) or "features" not in obj:
        raise ValueError("request must be a JSON object with 'features'")
    return ScoreRequest(
        features=dict(obj["features"]),
        entity_ids=dict(obj.get("entityIds", {})),
        offset=float(obj.get("offset", 0.0)),
        uid=obj.get("uid"),
        model_version=obj.get("modelVersion"),
    )


def classify_exception(exc: BaseException):
    """(http_code, kind) for one request failure. ``kind`` separates the
    shed REASONS that share a status code — quota sheds and queue
    backpressure both 429, but tenants (and the soak bench) need to tell
    them apart."""
    kind = getattr(exc, "http_kind", None)
    if isinstance(exc, NotImplementedError):
        return 501, kind or "not_ported"
    if isinstance(exc, QuotaExceededError):
        return 429, kind or getattr(exc, "reason", "quota")
    if isinstance(exc, BackpressureError):
        return 429, kind or "backpressure"
    if isinstance(exc, (DeadlineExceededError, FutureTimeoutError)):
        return 504, kind or "deadline"
    if isinstance(exc, (ValueError, KeyError, json.JSONDecodeError)):
        return 400, kind or "bad_request"
    return 500, kind or "internal"


def _exception_from_payload(msg: dict) -> BaseException:
    """Rebuild the engine's exception type from a scorer error frame, so
    worker-side HTTP mapping is identical to the in-process path."""
    code = int(msg.get("code", 500))
    kind = msg.get("kind", "internal")
    text = str(msg.get("error", "scorer error"))
    exc: BaseException
    if code == 429:
        if kind in ("quota", "batch_capacity"):
            exc = QuotaExceededError(
                text, msg.get("tenant", "?"), reason=kind
            )
        else:
            exc = BackpressureError(text)
    elif code == 504:
        exc = DeadlineExceededError(text)
    elif code == 400:
        exc = ValueError(text)
    elif code == 501:
        exc = NotImplementedError(text)
    else:
        exc = RuntimeError(text)
    exc.http_kind = kind  # preserve the original classification verbatim
    return exc


def score_jsonl(body: bytes, submit, result_timeout_s: Optional[float] = None):
    """``/v1/score-batch`` core: submit every parseable line FIRST (they
    co-batch in the flusher), then collect in order. Each line resolves
    independently: ``{"score": s}`` on success, else ``{"error", "code",
    "kind"}`` — a malformed line is a per-line 400, never conflated with a
    429 shed (they used to share one except clause)."""
    futures: List[object] = []
    for line in body.splitlines():
        if not line.strip():
            continue
        try:
            futures.append(submit(json.loads(line)))
        except Exception as exc:  # noqa: BLE001 — per-line failure
            futures.append(exc)
    out = []
    for f in futures:
        if isinstance(f, BaseException):
            code, kind = classify_exception(f)
            out.append({"error": str(f), "code": code, "kind": kind})
        else:
            try:
                res = f.result(result_timeout_s)
                out.append({"score": res["score"]})
            except Exception as exc:  # noqa: BLE001 — per-line failure
                code, kind = classify_exception(exc)
                out.append({"error": str(exc), "code": code, "kind": kind})
    return out


def apply_feedback(engine, body: dict) -> dict:
    """``/v1/feedback`` core, shared by both deployment shapes: ``body`` is
    one ``{"uid", "label", "ts"?}`` object or ``{"labels": [...]}`` for a
    batch. Each item completes the feedback spool's label join for a
    previously scored request; items whose uid already aged out of the join
    window are counted as ``dropped``, not errors. Raises ``ValueError``
    (→ 400) when the engine has no spool attached or an item is malformed."""
    if not isinstance(body, dict):
        raise ValueError("feedback body must be a JSON object")
    items = body.get("labels")
    if items is None:
        items = [body]
    if not isinstance(items, list):
        raise ValueError("'labels' must be a list of {uid, label} objects")
    joined = 0
    dropped = 0
    for item in items:
        if (
            not isinstance(item, dict)
            or "uid" not in item
            or "label" not in item
        ):
            raise ValueError("each feedback item needs 'uid' and 'label'")
        ts = item.get("ts")
        ok = engine.feedback_label(
            str(item["uid"]),
            float(item["label"]),
            float(ts) if ts is not None else None,
        )
        if ok:
            joined += 1
        else:
            dropped += 1
    return {"joined": joined, "dropped": dropped}


def _stamp_labels(snap: dict, **labels) -> dict:
    """Fill ``labels`` into a metric snapshot record where absent (existing
    labels win): how a merged scrape tells the front end's instruments from
    the scorer's without rewriting what the producer stamped."""
    merged = dict(snap.get("labels") or {})
    for k, v in labels.items():
        merged.setdefault(str(k), str(v))
    return dict(snap, labels=merged)


# ---------------------------------------------------------------------------
# Framed IPC
# ---------------------------------------------------------------------------


def _send_frame(sock: socket.socket, obj: dict, lock: threading.Lock) -> None:
    data = json.dumps(obj).encode()
    with lock:
        sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"IPC frame of {length} bytes exceeds cap")
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    return json.loads(payload.decode())


# ---------------------------------------------------------------------------
# Transport endpoints: Unix paths and tcp://host:port
# ---------------------------------------------------------------------------


def parse_endpoint(endpoint: str):
    """``("unix", path)`` for a plain filesystem path, ``("tcp", (host,
    port))`` for a ``tcp://host:port`` URL. Everything above the socket —
    the frame protocol, op table, trace propagation — is family-agnostic."""
    if endpoint.startswith("tcp://"):
        hostport = endpoint[len("tcp://"):]
        host, sep, port = hostport.rpartition(":")
        if not sep:
            raise ValueError(f"tcp endpoint needs host:port, got {endpoint!r}")
        return "tcp", (host or "127.0.0.1", int(port))
    return "unix", endpoint


def _hmac_hex(secret: str, message: str) -> str:
    return hmac.new(
        secret.encode(), message.encode(), hashlib.sha256
    ).hexdigest()


def _auth_server(conn: socket.socket, secret: str) -> bool:
    """Server half of the mutual challenge/response handshake, first frames
    on the connection: we challenge with a fresh per-connection nonce, the
    peer answers HMAC-SHA256(secret, nonce) plus its own nonce, and we prove
    ourselves back over that — so neither side ever sends the secret, and a
    recorded handshake can't be replayed against either end."""
    lock = threading.Lock()
    nonce = os.urandom(16).hex()
    try:
        conn.settimeout(10.0)
        _send_frame(conn, dict(op="auth_challenge", nonce=nonce), lock)
        msg = _recv_frame(conn)
        got = str((msg or {}).get("mac", ""))
        if not hmac.compare_digest(_hmac_hex(secret, nonce), got):
            registry().counter("fleet_auth_failures_total").inc()
            _send_frame(conn, dict(op="auth_fail"), lock)
            return False
        peer_nonce = str((msg or {}).get("nonce", ""))
        _send_frame(
            conn, dict(op="auth_ok", mac=_hmac_hex(secret, peer_nonce)), lock
        )
        conn.settimeout(None)
        return True
    except (OSError, ValueError):
        return False


def _auth_client(sock: socket.socket, secret: str) -> None:
    """Client half: answer the server's challenge, then verify the server's
    proof over OUR nonce before trusting anything it frames back. A MAC
    mismatch raises ``PermissionError`` — callers must not retry it the way
    they retry a not-yet-listening endpoint."""
    lock = threading.Lock()
    sock.settimeout(10.0)
    msg = _recv_frame(sock)
    if not msg or msg.get("op") != "auth_challenge":
        raise ConnectionError("scorer endpoint did not issue auth challenge")
    nonce = os.urandom(16).hex()
    _send_frame(
        sock,
        dict(
            op="auth_response",
            mac=_hmac_hex(secret, str(msg.get("nonce", ""))),
            nonce=nonce,
        ),
        lock,
    )
    reply = _recv_frame(sock)
    if (
        not reply
        or reply.get("op") != "auth_ok"
        or not hmac.compare_digest(
            _hmac_hex(secret, nonce), str(reply.get("mac", ""))
        )
    ):
        raise PermissionError(
            "fleet transport auth failed (shared secret mismatch)"
        )
    sock.settimeout(None)


# ---------------------------------------------------------------------------
# Scorer side (the one device-owning process)
# ---------------------------------------------------------------------------


class ScorerServer:
    """Accepts worker connections on a Unix socket and executes ops against
    the engine. Per connection: one reader thread (parses frames, submits)
    and one writer thread (serializes responses from a queue) — responses
    complete out of order via the engine futures' done-callbacks, so a
    single connection carries arbitrarily many in-flight requests."""

    def __init__(self, engine, socket_path: str, secret: Optional[str] = None):
        self.engine = engine
        self.socket_path = socket_path
        self._family = parse_endpoint(socket_path)[0]
        if secret is None and self._family == "tcp":
            secret = os.environ.get(FLEET_SECRET_ENV)
        if self._family == "tcp" and not secret:
            raise ValueError(
                "TCP scorer endpoints require a shared secret "
                f"(set ${FLEET_SECRET_ENV}) — refusing to listen "
                "unauthenticated off-host"
            )
        self.secret = secret
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False

    def start(self) -> None:
        fam, addr = parse_endpoint(self.socket_path)
        if fam == "unix":
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(self.socket_path)
            self._sock.listen(128)
        else:
            self._sock = socket.create_server(addr, backlog=128)
            host, port = self._sock.getsockname()[:2]
            # Re-resolve so a port-0 bind advertises the real port.
            self.socket_path = f"tcp://{host}:{port}"
        t = threading.Thread(
            target=self._accept_loop, name="scorer-accept", daemon=True
        )
        t.start()
        self._threads.append(t)

    def _accept_loop(self) -> None:
        assert self._sock is not None
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            if self._family == "tcp":
                try:
                    conn.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                except OSError:
                    pass
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="scorer-conn", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        if self.secret is not None and not _auth_server(conn, self.secret):
            try:
                conn.close()
            except OSError:
                pass
            return
        out: "queue.Queue[Optional[dict]]" = queue.Queue()
        wlock = threading.Lock()

        def _writer() -> None:
            while True:
                msg = out.get()
                if msg is None:
                    return
                try:
                    _send_frame(conn, msg, wlock)
                except OSError:
                    return  # worker went away; reader notices EOF too

        wt = threading.Thread(target=_writer, name="scorer-write", daemon=True)
        wt.start()
        try:
            while True:
                try:
                    msg = _recv_frame(conn)
                except (OSError, ValueError):
                    break
                if msg is None:
                    break
                self._dispatch(msg, out)
        finally:
            out.put(None)
            wt.join(timeout=5.0)
            try:
                conn.close()
            except OSError:
                pass

    def _error_payload(self, rid, exc: BaseException) -> dict:
        code, kind = classify_exception(exc)
        payload = dict(
            id=rid, ok=False, code=code, kind=kind, error=str(exc)
        )
        if isinstance(exc, QuotaExceededError):
            payload["tenant"] = exc.tenant
        return payload

    def _dispatch(self, msg: dict, out: "queue.Queue") -> None:
        rid = msg.get("id")
        op = msg.get("op")
        try:
            if op == "score":
                self._op_score(rid, msg, out)
            elif op == "stats":
                out.put(dict(id=rid, ok=True, result=self._op_stats()))
            elif op == "reload":
                # Off-thread: a reload warms a whole model generation;
                # this connection's scores must keep flowing meanwhile.
                threading.Thread(
                    target=self._op_reload, args=(rid, msg, out),
                    name="scorer-reload", daemon=True,
                ).start()
            elif op == "feedback":
                out.put(dict(
                    id=rid, ok=True, result=self._op_feedback(msg),
                ))
            elif op == "metrics":
                out.put(dict(id=rid, ok=True, result=self._op_metrics(msg)))
            elif op == "traces":
                out.put(dict(id=rid, ok=True, result=self._op_traces(msg)))
            elif op == "experiment":
                out.put(dict(
                    id=rid, ok=True, result=self._op_experiment(msg),
                ))
            elif op == "ping":
                out.put(dict(id=rid, ok=True, result="pong"))
            else:
                raise ValueError(f"unknown scorer op {op!r}")
        except Exception as exc:  # noqa: BLE001 — per-request failure
            out.put(self._error_payload(rid, exc))

    def _op_score(self, rid, msg: dict, out: "queue.Queue") -> None:
        req = request_from_json(msg.get("request") or {})
        ctx = TraceContext.from_dict(msg.get("trace"))
        sid: Optional[str] = None
        if ctx is not None and ctx.sampled:
            # This hop's span id, minted before the span completes, so the
            # request's downstream spans can parent on it.
            sid = new_span_id()
            req.trace = ctx.child(sid).to_dict()
        t0 = time.monotonic()
        fut = self.engine.submit(
            req,
            tenant=msg.get("tenant"),
            priority=msg.get("priority") or INTERACTIVE,
            model_version=msg.get("modelVersion"),
        )

        def _done(f: Future) -> None:
            exc = f.exception()
            if sid is not None:
                try:
                    dt = time.monotonic() - t0
                    tracer().record("scorer/score", dt, parent="", context=ctx, span_id=sid)
                    flight_recorder().finish(ctx.trace_id, dt, error=None if exc is None else str(exc),
                                             degraded=bool(getattr(req, "degraded", False)), forced=ctx.forced)
                except Exception:
                    pass  # telemetry never fails the response
            if exc is not None:
                out.put(self._error_payload(rid, exc))
            else:
                # The engine records the version that scored the request.
                out.put(dict(id=rid, ok=True, result=dict(
                    score=f.result(), modelVersion=req.model_version or self.engine.model_version)))

        fut.add_done_callback(_done)

    def _op_stats(self) -> dict:
        return self.engine.stats()

    def _op_feedback(self, msg: dict) -> dict:
        return apply_feedback(self.engine, msg.get("body") or {})

    def _op_experiment(self, msg: dict) -> dict:
        return experiment_rollup(self.engine)

    def _op_metrics(self, msg: dict) -> List[dict]:
        """The registry snapshot for the worker-side ``/metrics`` merge."""
        return registry().snapshot()

    def _op_traces(self, msg: dict) -> List[dict]:
        """This process's kept flight-recorder trees."""
        return flight_recorder().traces(limit=msg.get("limit"))

    def _op_reload(self, rid, msg: dict, out: "queue.Queue") -> None:
        try:
            info = reload_engine(self.engine, msg)
            out.put(dict(id=rid, ok=True, result=info))
        except Exception as exc:  # noqa: BLE001 — per-request failure
            out.put(self._error_payload(rid, exc))

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            conns = list(self._conns)
        if self._sock is not None:
            # Wake the accept loop with a connection of our own (it sees
            # _closed and returns): closing the listener does not interrupt
            # a blocked accept() everywhere, and the join below would wait
            # out its timeout.
            fam, addr = parse_endpoint(self.socket_path)
            try:
                if fam == "unix":
                    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as waker:
                        waker.settimeout(1.0)
                        waker.connect(addr)
                else:
                    socket.create_connection(addr, timeout=1.0).close()
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        if self._family == "unix" and os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Worker side
# ---------------------------------------------------------------------------


class ScorerClient:
    """One worker's connection to the scorer: id-correlated async frames.
    ``submit_score`` returns a Future resolving to the scorer's result dict
    (or raising the reconstructed engine exception); a lost connection
    fails every in-flight future with ``ConnectionError``."""

    def __init__(
        self,
        socket_path: str,
        connect_timeout_s: float = 120.0,
        secret: Optional[str] = None,
    ):
        fam, addr = parse_endpoint(socket_path)
        if secret is None and fam == "tcp":
            secret = os.environ.get(FLEET_SECRET_ENV)
        self.endpoint = socket_path
        deadline = time.monotonic() + connect_timeout_s
        last_err: Optional[BaseException] = None
        delay = 0.05  # capped exponential backoff while the scorer warms
        while True:
            sock: Optional[socket.socket] = None
            try:
                if fam == "unix":
                    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    sock.connect(addr)
                else:
                    sock = socket.create_connection(addr, timeout=10.0)
                    sock.settimeout(None)
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                if secret is not None:
                    _auth_client(sock, secret)
                break
            except PermissionError:
                # Wrong shared secret: retrying can't fix it.
                if sock is not None:
                    sock.close()
                raise
            except OSError as exc:
                last_err = exc
                if sock is not None:
                    sock.close()
                if time.monotonic() >= deadline:
                    raise ConnectionError(
                        f"scorer endpoint {socket_path} not reachable after "
                        f"{connect_timeout_s:.0f}s: {last_err}"
                    ) from last_err
                time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2.0, 1.0)
        self._sock = sock
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: Dict[int, Future] = {}
        self._next_id = 0
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="scorer-client-read", daemon=True
        )
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                msg = _recv_frame(self._sock)
                if msg is None:
                    break
                with self._plock:
                    fut = self._pending.pop(msg.get("id"), None)
                if fut is None:
                    continue
                if msg.get("ok"):
                    fut.set_result(msg.get("result"))
                else:
                    fut.set_exception(_exception_from_payload(msg))
        except (OSError, ValueError):
            pass
        finally:
            with self._plock:
                pending, self._pending = self._pending, {}
            for fut in pending.values():
                fut.set_exception(
                    ConnectionError("scorer connection lost")
                )

    def request(self, op: str, **payload) -> Future:
        fut: Future = Future()
        with self._plock:
            if self._closed:
                raise ConnectionError("scorer client closed")
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = fut
        try:
            _send_frame(
                self._sock, dict(id=rid, op=op, **payload), self._wlock
            )
        except OSError as exc:
            with self._plock:
                self._pending.pop(rid, None)
            raise ConnectionError(f"scorer connection lost: {exc}") from exc
        return fut

    def submit_score(
        self,
        raw_request: dict,
        tenant: Optional[str] = None,
        priority: str = INTERACTIVE,
        model_version: Optional[str] = None,
        trace: Optional[dict] = None,
    ) -> Future:
        return self.request(
            "score", request=raw_request, tenant=tenant, priority=priority,
            modelVersion=model_version, trace=trace,
        )

    def call(self, op: str, timeout_s: float = 30.0, **payload):
        return self.request(op, **payload).result(timeout_s)

    def close(self) -> None:
        with self._plock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._reader.join(timeout=5.0)


# ---------------------------------------------------------------------------
# HTTP layer (shared by in-process and multi-process deployments)
# ---------------------------------------------------------------------------


def reload_engine(engine, body: dict) -> dict:
    """``/v1/reload`` core: load ``{"modelDir"}`` (its delta chain resolved)
    as a host master with the engine's index maps and entity indexes (they
    are stable across a model's generations), then swap it in."""
    from photon_tpu_torch.io.model_io import load_resolved_game_model

    model_dir = body.get("modelDir")
    if not model_dir:
        raise ValueError("reload needs {'modelDir': path}")
    model = load_resolved_game_model(model_dir, engine._index_maps, engine._entity_indexes, to_device=False)
    return engine.reload(model, body.get("modelVersion") or model_dir)


def experiment_rollup(engine) -> dict:
    """``/v1/experiment`` payload: the manifest-derived experiment rollup
    for the publish root this engine serves from (the manifests ARE the
    experiment store — a dead manager leaves a readable history), plus the
    engine's LIVE candidate state (resident shadow lanes and their
    divergence counters), which manifests can't know."""
    from photon_tpu_torch.experiment import experiment_summary

    root = getattr(engine, "artifacts_dir", None)
    if not root:
        version = str(getattr(engine, "model_version", "") or "")
        parent = os.path.dirname(version.rstrip("/"))
        root = parent if os.path.isdir(parent) else None
    doc: dict = {"publishRoot": root, "experiments": []}
    if root:
        try:
            doc.update(experiment_summary(root))
        except Exception as exc:  # noqa: BLE001 — rollup is best-effort
            doc["error"] = str(exc)
    try:
        doc["live"] = {
            "primary": engine.model_version,
            "shadows": engine.shadow_versions,
            "shadowStats": engine.shadow_stats(),
        }
    except Exception:  # noqa: BLE001 — a closing engine must not 500 this
        pass
    return doc


class LocalBackend:
    """Direct engine access — the single-process deployment shape."""

    def __init__(self, engine, result_timeout_s: float = 120.0):
        self.engine = engine
        self.result_timeout_s = result_timeout_s

    def submit(
        self, raw_request: dict, tenant: Optional[str], priority: str,
        model_version: Optional[str] = None,
        trace: Optional[dict] = None,
    ) -> Future:
        req = request_from_json(raw_request)
        ctx = TraceContext.from_dict(trace)
        sid: Optional[str] = None
        if ctx is not None and ctx.sampled:
            sid = new_span_id()
            req.trace = ctx.child(sid).to_dict()
        t0 = time.monotonic()
        src = self.engine.submit(
            req, tenant=tenant, priority=priority,
            model_version=model_version,
        )
        dst: Future = Future()

        def _done(f: Future) -> None:
            exc = f.exception()
            # The HTTP handler finishes the trace (it also times the
            # response write); it reads the degraded flag off the future.
            dst._photon_degraded = bool(getattr(req, "degraded", False))
            if sid is not None:
                try:
                    tracer().record("engine/score", time.monotonic() - t0, parent="", context=ctx, span_id=sid)
                except Exception:
                    pass
            if exc is not None:
                dst.set_exception(exc)
            else:
                # The engine records the version that scored the request.
                dst.set_result(dict(score=f.result(), modelVersion=req.model_version or self.engine.model_version))

        src.add_done_callback(_done)
        return dst

    def stats(self) -> dict:
        return self.engine.stats()

    def metrics_text(self) -> str:
        return render_prometheus(registry().snapshot(), extra_labels={"replica": "frontend"})

    def traces(self, limit: Optional[int] = None) -> List[dict]:
        return merge_trace_dumps(flight_recorder().traces(limit=limit))

    def reload(self, body: dict) -> dict:
        return reload_engine(self.engine, body)

    def feedback(self, body: dict) -> dict:
        return apply_feedback(self.engine, body)

    def experiment(self) -> dict:
        return experiment_rollup(self.engine)


class RemoteBackend:
    """Scorer access over the IPC channel — the worker deployment shape."""

    def __init__(self, client: ScorerClient, worker_index: int = 0,
                 result_timeout_s: float = 120.0):
        self.client = client
        self.worker_index = worker_index
        self.result_timeout_s = result_timeout_s

    def submit(
        self, raw_request: dict, tenant: Optional[str], priority: str,
        model_version: Optional[str] = None,
        trace: Optional[dict] = None,
    ) -> Future:
        return self.client.submit_score(
            raw_request, tenant, priority, model_version, trace=trace
        )

    def stats(self) -> dict:
        stats = self.client.call("stats", timeout_s=30.0)
        stats["worker"] = self.worker_index
        stats["workerPid"] = os.getpid()
        return stats

    def metrics_text(self) -> str:
        """The merged Prometheus text: the scorer's instruments (labelled
        ``replica="scorer"``) and this worker's own."""
        remote: List[dict] = []
        try:
            remote = self.client.call("metrics", timeout_s=30.0) or []
        except Exception:
            registry().counter("frontend_scorer_scrape_errors_total").inc()
        snaps = [_stamp_labels(s, replica=f"worker{self.worker_index}") for s in registry().snapshot()]
        snaps.extend(_stamp_labels(s, replica="scorer") for s in remote)
        return render_prometheus(snaps)

    def traces(self, limit: Optional[int] = None) -> List[dict]:
        """Kept traces merged by trace id across this worker and the
        scorer: one request's spans reassemble into one entry whichever
        process kept which hop."""
        local = flight_recorder().traces(limit=limit)
        try:
            remote = self.client.call("traces", timeout_s=30.0, limit=limit)
        except Exception:
            remote = []
        return merge_trace_dumps(local + (remote or []))

    def reload(self, body: dict) -> dict:
        # A reload builds + warms a whole generation; give it real time.
        return self.client.call(
            "reload", timeout_s=600.0,
            modelDir=body.get("modelDir"),
            modelVersion=body.get("modelVersion"),
        )

    def feedback(self, body: dict) -> dict:
        return self.client.call("feedback", timeout_s=30.0, body=body)

    def experiment(self) -> dict:
        return self.client.call("experiment", timeout_s=30.0)


def make_http_handler(backend):
    """The ONE endpoint implementation, parameterized by backend — local
    engine or remote scorer. Tenant comes from the ``X-Tenant`` header (or
    a per-request ``tenant`` field), priority from ``X-Priority`` /
    ``priority`` (``interactive`` default, ``batch`` for bulk callers),
    and a version pin from ``X-Model-Version`` / ``modelVersion`` —
    pinned requests score on that resident generation (400 on an unknown
    pin); unpinned requests follow the primary."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # A response is written as headers, then body: without TCP_NODELAY
        # the body waits for the client's delayed ACK (~40 ms a request).
        disable_nagle_algorithm = True
        # Idle keep-alive connections release their thread after this, so
        # worker drain (server_close joins handler threads) can finish.
        timeout = 5.0

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("http: " + fmt, *args)

        def _reply(self, code: int, payload: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def _reply_json(self, code: int, obj) -> None:
            self._reply(code, (json.dumps(obj) + "\n").encode())

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def _tenant_priority(self, obj: Optional[dict] = None):
            tenant = self.headers.get("X-Tenant")
            priority = self.headers.get("X-Priority")
            if isinstance(obj, dict):
                tenant = obj.get("tenant", tenant)
                priority = obj.get("priority", priority)
            priority = priority or INTERACTIVE
            if priority not in PRIORITIES:
                raise ValueError(
                    f"priority must be one of {PRIORITIES}, got {priority!r}"
                )
            return tenant, priority

        def _model_version(self, obj: Optional[dict] = None):
            version = self.headers.get("X-Model-Version")
            if isinstance(obj, dict):
                version = obj.get("modelVersion", version)
            return version

        def _query_int(self, key: str) -> Optional[int]:
            if "?" not in self.path:
                return None
            vals = parse_qs(self.path.split("?", 1)[1]).get(key)
            try:
                return int(vals[0]) if vals else None
            except (TypeError, ValueError):
                return None

        def do_GET(self):
            try:
                route = self.path.split("?", 1)[0]
                if route == "/healthz":
                    self._reply_json(200, backend.stats())
                elif route == "/metrics":
                    self._reply(200, backend.metrics_text().encode(), ctype=PROMETHEUS_CONTENT_TYPE)
                elif route == "/v1/traces":
                    self._reply_json(200, {"traces": backend.traces(limit=self._query_int("limit"))})
                elif route == "/v1/experiment":
                    self._reply_json(200, backend.experiment())
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})
            except Exception as exc:  # noqa: BLE001 — classified below
                code, kind = classify_exception(exc)
                if code == 500:
                    logger.exception("request failed")
                self._reply_json(code, {"error": str(exc), "kind": kind})

        def do_POST(self):
            try:
                if self.path == "/v1/score":
                    self._score_one()
                elif self.path in ("/v1/score-batch", "/v1/score_batch"):
                    self._score_jsonl()
                elif self.path == "/v1/reload":
                    body = self._body()
                    info = backend.reload(json.loads(body) if body else {})
                    self._reply_json(200, info)
                elif self.path == "/v1/feedback":
                    body = self._body()
                    info = backend.feedback(json.loads(body) if body else {})
                    self._reply_json(200, info)
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})
            except Exception as exc:  # noqa: BLE001 — classified below
                code, kind = classify_exception(exc)
                if code == 500:
                    logger.exception("request failed")
                payload = {"error": str(exc), "kind": kind}
                tenant = getattr(exc, "tenant", None)
                if tenant is not None:
                    payload["tenant"] = tenant
                self._reply_json(code, payload)

        def _trace_context(self) -> TraceContext:
            """Adopt the client's ``traceparent`` (it arrives forced: an
            explicit header asks to SEE the trace), or mint a fresh
            tail-sampled root."""
            ctx = TraceContext.from_traceparent(self.headers.get("traceparent"))
            return ctx if ctx is not None else mint_context()

        def _score_one(self):
            obj = json.loads(self._body())
            tenant, priority = self._tenant_priority(obj)
            ctx = self._trace_context()
            sid = new_span_id()
            t0 = time.monotonic()
            error: Optional[str] = None
            fut: Optional[Future] = None
            try:
                fut = backend.submit(obj, tenant, priority, self._model_version(obj),
                                     trace=ctx.child(sid).to_dict())
                self._reply_json(200, fut.result(backend.result_timeout_s))
            except Exception as exc:
                error = str(exc)
                raise
            finally:
                dt = time.monotonic() - t0
                try:
                    tracer().record("http/v1/score", dt, parent="", context=ctx, span_id=sid)
                    flight_recorder().finish(ctx.trace_id, dt, error=error,
                                             degraded=bool(getattr(fut, "_photon_degraded", False)),
                                             forced=ctx.forced)
                except Exception:
                    pass  # telemetry never fails the response

        def _score_jsonl(self):
            tenant, priority = self._tenant_priority()
            version = self._model_version()
            ctx = self._trace_context()
            sid = new_span_id()
            down = ctx.child(sid).to_dict()
            t0 = time.monotonic()
            try:
                out = score_jsonl(
                    self._body(),
                    lambda obj: backend.submit(obj, tenant, priority, obj.get("modelVersion", version), trace=down),
                    result_timeout_s=backend.result_timeout_s,
                )
                payload = "".join(json.dumps(o) + "\n" for o in out).encode()
                self._reply(200, payload, ctype="application/jsonl")
            finally:
                dt = time.monotonic() - t0
                try:
                    tracer().record("http/v1/score-batch", dt, parent="", context=ctx, span_id=sid)
                    # Per-line failures answer in the body, so the batch
                    # itself finishes clean; a forced or slow one still keeps.
                    flight_recorder().finish(ctx.trace_id, dt, forced=ctx.forced)
                except Exception:
                    pass

    return Handler


class ServingHTTPServer(ThreadingHTTPServer):
    """The in-process HTTP server: a listen backlog for many concurrent
    clients (the stdlib's 5 drops connections under load), handler threads
    that do not hold the process open."""

    request_queue_size = 128
    daemon_threads = True


class _InheritedSocketHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer over an already-bound, already-listening socket
    (the shared listener). ``daemon_threads=False`` makes ``server_close``
    join in-flight handler threads: the worker-side drain."""

    daemon_threads = False

    def __init__(self, sock: socket.socket, handler):
        socketserver.BaseServer.__init__(self, sock.getsockname()[:2], handler)
        self.socket = sock
        host, port = sock.getsockname()[:2]
        self.server_name = host
        self.server_port = port


def worker_main(listen_sock: socket.socket, scorer_path: str, worker_index: int,
                connect_timeout_s: float = 120.0) -> None:
    """Body of one spawned HTTP worker: blocks until SIGTERM/SIGINT, then
    drains in-flight requests and returns. It touches no CUDA."""
    import signal as _signal

    client = ScorerClient(scorer_path, connect_timeout_s=connect_timeout_s)
    backend = RemoteBackend(client, worker_index=worker_index)
    server = _InheritedSocketHTTPServer(listen_sock, make_http_handler(backend))

    def _stop(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    _signal.signal(_signal.SIGTERM, _stop)
    _signal.signal(_signal.SIGINT, _stop)
    logger.info("serve worker %d up (pid %d)", worker_index, os.getpid())
    try:
        server.serve_forever(poll_interval=0.1)
    finally:
        server.server_close()  # joins in-flight handler threads
        client.close()


def _worker_entry(listen_sock: socket.socket, scorer_path: str, worker_index: int) -> None:
    try:
        worker_main(listen_sock, scorer_path, worker_index)
    except BaseException:  # noqa: BLE001 — report, then exit non-zero
        traceback.print_exc()
        raise SystemExit(1)


# ---------------------------------------------------------------------------
# Parent-side orchestration
# ---------------------------------------------------------------------------


class ServingFrontend:
    """Lifecycle of the multi-process deployment: ``__init__`` (bind the
    shared listener) → ``start_workers()`` (spawned processes, handed the
    listener) → build the engine → ``start_scorer(engine)`` → serve →
    ``shutdown()`` (SIGTERM the workers first so admission stops, then close
    the IPC server; the caller drains the engine last). Workers retry their
    connection to the scorer socket until the (warm-up-bound) parent
    listens."""

    def __init__(self, host: str, port: int, num_workers: int, backlog: int = 128,
                 scorer_endpoint: Optional[str] = None):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = int(num_workers)
        self._listen_sock = socket.create_server((host, port), backlog=backlog)
        self.host, self.port = self._listen_sock.getsockname()[:2]
        self._scorer_dir = tempfile.mkdtemp(prefix="photon-serve-")
        if scorer_endpoint is None:
            self.scorer_path = os.path.join(self._scorer_dir, "scorer.sock")
        else:
            # Workers start connecting before the scorer binds, so a tcp
            # endpoint names its port up front; the shared secret rides
            # $PHOTON_TPU_FLEET_SECRET, never argv.
            if parse_endpoint(scorer_endpoint)[0] == "tcp" and parse_endpoint(scorer_endpoint)[1][1] == 0:
                raise ValueError("tcp scorer endpoints need an explicit port (workers start before the scorer binds)")
            self.scorer_path = scorer_endpoint
        self.procs: List = []
        self.worker_exits: Dict[int, int] = {}
        self.scorer: Optional[ScorerServer] = None
        self._started = False

    def start_workers(self) -> None:
        """Spawn the HTTP workers (fresh interpreters: nothing of this
        process's CUDA state is copied), each handed the shared listener."""
        import multiprocessing

        assert not self._started, "workers already started"
        self._started = True
        ctx = multiprocessing.get_context("spawn")
        for widx in range(self.num_workers):
            proc = ctx.Process(target=_worker_entry, args=(self._listen_sock, self.scorer_path, widx),
                               name=f"photon-serve-worker-{widx}", daemon=False)
            proc.start()
            self.procs.append(proc)
        self._listen_sock.close()  # only workers accept

    def start_scorer(self, engine) -> None:
        self.scorer = ScorerServer(engine, self.scorer_path)
        self.scorer.start()

    def poll_workers(self) -> List[int]:
        """Reap the workers that died; returns their pids. The survivors
        keep accepting on the shared listener."""
        reaped = []
        for proc in self.procs:
            if proc.pid in self.worker_exits or proc.exitcode is None:
                continue
            self.worker_exits[proc.pid] = proc.exitcode
            reaped.append(proc.pid)
            registry().counter("serve_worker_exits_total").inc()
            logger.warning("serve worker pid %d exited with code %s (%d/%d workers remain)", proc.pid,
                           proc.exitcode, self.live_workers(), self.num_workers)
        return reaped

    def live_workers(self) -> int:
        return sum(1 for p in self.procs if p.exitcode is None)

    def shutdown(self, timeout_s: float = 15.0) -> Dict[int, int]:
        """Drain in order: workers first (no new admissions), then the IPC
        server; the caller drains the engine last."""
        exits: Dict[int, int] = {}
        for proc in self.procs:
            if proc.exitcode is None:
                proc.terminate()
        for proc in self.procs:
            proc.join(timeout_s)
            if proc.exitcode is None:
                proc.kill()
                proc.join(5.0)
            exits[proc.pid] = proc.exitcode
            self.worker_exits[proc.pid] = proc.exitcode
        if self.scorer is not None:
            self.scorer.close()
        shutil.rmtree(self._scorer_dir, ignore_errors=True)
        return exits
