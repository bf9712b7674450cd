"""HTTP serving front-end over :class:`avdn_tpu_torch.serve.Navigator` (the
port's counterpart of ``avdn_tpu/serve_http.py``). Stdlib only
(``http.server``).

Endpoints
---------
``GET /healthz``
    ``{"status": "ok", "family": ..., "serve_batch": N, "requests": n,
    "batches": m}``.
``POST /navigate``
    Body ``{"items": [ANDH-format item, ...]}``. Response
    ``{"predictions": [record, ...]}``: one record per item, **in request
    order**, each carrying ``instr_id`` (the client's
    ``map_name__route_index`` when ``route_index`` was given, otherwise a
    server-assigned one). Records are the ``assemble_trajectories`` dicts
    with numpy converted to JSON lists.

Error contract: client faults are 4xx. A malformed body or payload, or an
invalid item (missing or garbage fields), is 400; a body over
``max_body_bytes`` (refused before it is read) or more than ``max_items``
items is 413. Only dispatcher or device failures return 500.

Concurrency: handler threads (``ThreadingHTTPServer``) enqueue into a
:class:`NavigatorService`, whose one dispatcher thread coalesces concurrent
small requests into one padded batch of up to ``serve_batch`` items (waiting
at most ``max_wait_ms`` after the first arrival) and splits a request larger
than ``serve_batch`` into batches of at most ``serve_batch``, answered once,
in request order, when its last batch is done. The dispatcher launches
batch i+1 on the card before it waits for and answers batch i.

CLI::

    python -m avdn_tpu_torch.serve_http --port 8080 --resume_file agent.pt \
        --root_dir <dataset> [any config.Args flag]
"""

from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np


def _jsonable(x):
    """Recursively convert a prediction record to JSON-serializable types."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


class BadRequest(ValueError):
    """Client-fault request error (HTTP 400, never 500)."""


class _Pending:
    """One request: its tagged items, ``(tag id, client id)`` per item, and
    the event its handler thread waits on."""

    __slots__ = ("items", "ids", "event", "result", "error")

    def __init__(self, items, ids):
        self.items = items
        self.ids = ids
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Job:
    """A coalesced group of requests, run as one or more device batches;
    answered when the predictions of its last batch are in."""

    def __init__(self, requests: List[_Pending], serve_batch: int):
        self.requests = requests
        items = [it for p in requests for it in p.items]
        self.chunks = [items[lo: lo + serve_batch]
                       for lo in range(0, len(items), serve_batch)]
        self.left = len(self.chunks)
        self.preds: Dict[str, dict] = {}
        self.failed = False


class NavigatorService:
    """Thread-safe coalescing front of a :class:`Navigator`.

    ``submit(items)`` blocks until the dispatcher thread has navigated the
    items and returns their records in request order. Requests that arrive
    within ``max_wait_ms`` of each other are merged into one batch while
    the merged size stays ≤ ``serve_batch``; a request of more items runs
    alone, as several batches.
    """

    def __init__(self, nav, max_wait_ms: float = 5.0):
        self.nav = nav
        self.max_wait_s = max_wait_ms / 1e3
        self._lock = threading.Condition()
        self._queue: List[_Pending] = []
        self._seq = 0
        self._closed = False
        self.requests_served = 0
        self.batches_run = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="avdn-serve-dispatch")
        self._thread.start()

    _REQUIRED = ("map_name", "instructions", "angle", "lat_ratio",
                 "lng_ratio", "gps_botm_left", "gps_top_right")

    # -- client side ---------------------------------------------------
    def submit(self, items: List[dict]) -> List[dict]:
        if not items:
            return []
        with self._lock:
            if self._closed:
                raise RuntimeError("NavigatorService is closed")
            seq = self._seq
            self._seq += 1
        # Validate and normalize per request, before merging: a malformed
        # item fails its own request, never a coalesced neighbour's. The
        # Navigator keys results by map_name__route_index, so each item gets
        # a route id unique to this request (clients may omit route_index or
        # reuse one); the client's instr_id is restored in the reply.
        tagged, ids = [], []
        for i, raw in enumerate(items):
            if not isinstance(raw, dict):
                raise BadRequest(f"item {i}: expected an object, got "
                                 f"{type(raw).__name__}")
            missing = [k for k in self._REQUIRED if k not in raw]
            if not (raw.get("gt_path_corners")
                    or raw.get("start_corners") is not None):
                missing.append("start_corners|gt_path_corners")
            if missing:
                raise BadRequest(f"item {i}: missing fields {missing}")
            try:
                it = self.nav._normalize_item(raw)
            except (ValueError, TypeError, KeyError) as e:
                raise BadRequest(f"item {i}: {e!r}") from e
            orig_route = raw.get("route_index")
            it["route_index"] = f"s{seq}x{i}_1"
            tagged.append(it)
            ids.append((it["map_name"] + "__" + it["route_index"],
                        it["map_name"] + "__" + str(orig_route)
                        if orig_route is not None else None))
        req = _Pending(tagged, ids)
        with self._lock:
            self._queue.append(req)
            self._lock.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout=5)

    # -- dispatcher side -------------------------------------------------
    def _drain(self, in_flight: bool) -> List[_Pending]:
        """Coalesce queued requests: keep accepting for up to ``max_wait_s``
        after the first one, or until ``serve_batch`` items are pending.
        With a batch ``in_flight`` the first wait is bounded (the dispatcher
        must come back to answer it); otherwise it blocks until work
        arrives or the service closes. A first request of more than
        ``serve_batch`` items is taken alone. Runs under the lock."""
        if in_flight:
            if not self._queue and not self._closed:
                self._lock.wait(timeout=self.max_wait_s)
        else:
            while not self._queue and not self._closed:
                self._lock.wait()
        if not self._queue:
            return []
        cap = self.nav.serve_batch
        deadline = time.monotonic() + self.max_wait_s
        while (sum(len(p.items) for p in self._queue) < cap
               and not self._closed):
            left = deadline - time.monotonic()
            if left <= 0 or not self._lock.wait(timeout=left):
                break
        batch, n = [], 0
        while self._queue and (n == 0 or n + len(self._queue[0].items) <= cap):
            p = self._queue.pop(0)
            batch.append(p)
            n += len(p.items)
        return batch

    @staticmethod
    def _fail(job: _Job, e: BaseException):
        job.failed = True
        for p in job.requests:
            p.error = e
            p.event.set()

    def _respond(self, pending):
        """Wait for a launched batch, keep its predictions, and answer its
        job's requests when it was the job's last batch."""
        handle, job = pending
        try:
            job.preds.update(self.nav.drain(handle))
            self.batches_run += 1
            job.left -= 1
            if job.left or job.failed:  # more to come, or already answered
                return
            for p in job.requests:
                recs = []
                for tag_id, orig_id in p.ids:
                    rec = dict(job.preds[tag_id])
                    rec["instr_id"] = orig_id or tag_id
                    recs.append(rec)
                p.result = recs
                self.requests_served += 1
            for p in job.requests:
                p.event.set()
        except BaseException as e:  # every waiter of the job sees it
            self._fail(job, e)

    def _run(self):
        """Software-pipelined dispatch loop. The launch on the card is
        asynchronous, so while batch i runs the dispatcher coalesces and
        prepares batch i+1 (map decode, tokenisation, upload) and launches
        it before it waits for batch i and answers its requests."""
        pending = None  # (launched handle, _Job)
        chunks = collections.deque()  # (job, items) still to launch
        closed = False
        while True:
            if not chunks:
                with self._lock:
                    batch = self._drain(in_flight=pending is not None)
                    closed = self._closed
                if batch:
                    job = _Job(batch, self.nav.serve_batch)
                    chunks.extend((job, c) for c in job.chunks)
            next_pending = None
            while chunks and next_pending is None:
                job, items = chunks.popleft()
                if job.failed:
                    continue
                try:
                    next_pending = (self.nav.launch(self.nav.prepare(items)), job)
                except BaseException as e:
                    self._fail(job, e)
            if pending is not None:
                self._respond(pending)
            pending = next_pending
            if pending is None and not chunks and closed:
                with self._lock:
                    if not self._queue:
                        return  # closed and drained


class _Handler(BaseHTTPRequestHandler):
    # class attributes set by make_server()
    service: NavigatorService = None
    family: str = "et"
    quiet: bool = True
    # request caps: a runaway body must never exhaust the server's memory,
    # and a giant item list must never monopolise the dispatcher (413)
    max_body_bytes: int = 32 * 1024 * 1024
    max_items: int = 1024

    def log_message(self, fmt, *a):
        if not self.quiet:
            super().log_message(fmt, *a)

    def _send(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.rstrip("/") in ("/healthz", "/health", ""):
            self._send(200, {
                "status": "ok",
                "family": self.family,
                "serve_batch": self.service.nav.serve_batch,
                "requests": self.service.requests_served,
                "batches": self.service.batches_run,
            })
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path.rstrip("/") != "/navigate":
            self._send(404, {"error": f"no route {self.path}"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            self._send(400, {"error": "bad request: invalid Content-Length"})
            return
        if n > self.max_body_bytes:
            # refused before reading: the body is never buffered
            self._send(413, {"error": f"request body {n} bytes exceeds the "
                                      f"{self.max_body_bytes}-byte limit"})
            return
        try:
            payload = json.loads(self.rfile.read(n) or b"{}")
            items = payload["items"]
            if not isinstance(items, list):
                raise TypeError("items must be a list")
        except (KeyError, TypeError, ValueError) as e:
            self._send(400, {"error": f"bad request: {e!r}"})
            return
        if len(items) > self.max_items:
            self._send(413, {"error": f"{len(items)} items exceeds the "
                                      f"{self.max_items}-item limit"})
            return
        try:
            recs = self.service.submit(items)
        except BadRequest as e:
            self._send(400, {"error": str(e)[:500]})
            return
        except Exception as e:  # the dispatcher's or the card's failure
            self._send(500, {"error": repr(e)[:500]})
            return
        self._send(200, {"predictions": [_jsonable(r) for r in recs]})


def make_server(nav, host: str = "127.0.0.1", port: int = 8080,
                max_wait_ms: float = 5.0, quiet: bool = True,
                max_body_bytes: int = 32 * 1024 * 1024,
                max_items: int = 1024):
    """A ready-to-run ``ThreadingHTTPServer`` over ``nav``. The coalescing
    service is ``server.service``: close it after ``server.shutdown()``."""
    service = NavigatorService(nav, max_wait_ms=max_wait_ms)
    handler = type("Handler", (_Handler,), {
        "service": service, "family": nav.args.family, "quiet": quiet,
        "max_body_bytes": max_body_bytes, "max_items": max_items,
    })
    server = ThreadingHTTPServer((host, port), handler)
    server.service = service
    return server


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.serve import Navigator

    ap = argparse.ArgumentParser(
        "avdn_tpu_torch.serve_http", add_help=False,
        description="HTTP navigation serving (GET /healthz, POST /navigate)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--serve_batch", type=int, default=0,
                    help="items per device batch (0: --batch_size)")
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="coalescing window after the first queued request")
    ap.add_argument("--max_body_bytes", type=int, default=32 * 1024 * 1024,
                    help="refuse larger POST bodies with 413 (before reading)")
    ap.add_argument("--max_items", type=int, default=1024,
                    help="refuse requests with more items with 413")
    ap.add_argument("--family", default="et", choices=["et", "lstm"])
    own, rest = ap.parse_known_args(argv)
    nav = Navigator(parse_args(rest, family=own.family),
                    serve_batch=own.serve_batch or None)
    server = make_server(nav, own.host, own.port,
                         max_wait_ms=own.max_wait_ms, quiet=False,
                         max_body_bytes=own.max_body_bytes,
                         max_items=own.max_items)
    print(f"avdn_tpu_torch.serve_http: listening on {own.host}:{server.server_port} "
          f"(family={own.family}, serve_batch={nav.serve_batch}, device "
          f"{nav.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.service.close()


if __name__ == "__main__":
    main()
