"""Serving daemon: dynamic micro-batching + an HTTP face over a loaded
artifact.

Port of ``situation_recognition_tpu/server.py`` over this package's
``serving.load_inference``.

* :class:`DynamicBatcher` — each :meth:`submit` enqueues ONE example and
  returns a ``concurrent.futures.Future``; a dispatcher thread coalesces
  everything that arrives within ``max_wait_ms`` (up to ``max_batch``) into
  one device call and fans the rows back out.  The gt-verb entry
  (``fn.gt``) has its own queue and thread.  Admission is bounded
  (``max_queue``; overload raises :class:`BatcherSaturated`, 429 over
  HTTP), and a sliding window of latencies feeds ``/stats``.
* :func:`serve_http` — stdlib ``ThreadingHTTPServer``: ``POST /predict``
  with image bytes (``?verb=<name>`` for the gt entry), ``GET /healthz``,
  ``/stats``, ``/meta``, and opt-in ``POST /admin/reload``.
* ``python -m situation_recognition_tpu_torch.server <artifact>`` runs the
  daemon.

Responses use the standard label-axis softmax and map label ids through
``meta['label_list']`` with the reference's ``''``/``'UNK'`` → ``'-'``
display rule.
"""

from __future__ import annotations

import json
import queue
import threading
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch


class BatcherSaturated(RuntimeError):
    """Raised by submit when the bounded request queue is full — the
    backpressure signal (HTTP face maps it to 429).  Rejecting at admission
    keeps daemon memory bounded under overload instead of growing an
    unbounded queue of pinned image arrays."""


class DynamicBatcher:
    """Coalesce concurrent single-example requests into batched dispatches.

    ``fn``: a loaded artifact (``serving.load_inference``) or any callable
    taking a (B, 256, 256, 3) uint8 batch; if it has a ``.gt`` attribute,
    verb-conditioned submissions are served through it.
    ``max_batch``: cap per dispatch (default: the artifact's baked batch
    size, so a full window never pays the loader's chunking path).
    ``max_wait_ms``: how long the first request of a window waits for
    company before dispatching — the latency price of batching; 0 works
    (dispatch whatever is queued RIGHT NOW, still coalescing true
    concurrency).
    ``max_queue``: admission bound per entry queue; a submit beyond it
    raises :class:`BatcherSaturated` (429 at the HTTP face).  Bounds the
    daemon's memory at ~``max_queue`` pinned windows (196 KB each) per
    entry no matter the offered load.
    """

    _LATENCY_WINDOW = 1024      # ring of most-recent per-request latencies

    def __init__(self, fn: Callable, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0, max_queue: int = 256):
        self._fn = fn
        self._max_batch = int(max_batch or getattr(fn, "batch_size", 0) or 32)
        if self._max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self._max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "rejected": 0, "dispatches": 0,
                      "batched_examples": 0, "max_batch_seen": 0}
        self._queues = {"argmax": queue.Queue(maxsize=self.max_queue)}
        self._latency = {"argmax": _LatencyRing(self._LATENCY_WINDOW)}
        self._threads = []
        gt = getattr(fn, "gt", None)
        if gt is not None:
            self._queues["gt"] = queue.Queue(maxsize=self.max_queue)
            self._latency["gt"] = _LatencyRing(self._LATENCY_WINDOW)
        self._closed = False
        for kind in self._queues:
            t = threading.Thread(target=self._dispatch_loop, args=(kind,),
                                 name=f"srtorch-batcher-{kind}", daemon=True)
            t.start()
            self._threads.append(t)

    # ------------------------------------------------------------ submit

    def submit(self, image_u8: np.ndarray) -> Future:
        """One (256, 256, 3) uint8 window → Future of
        ``{"verb_logits": (V,), "verb_id": int, "noun_logits": (R, L)}``."""
        return self._submit("argmax", (self._check_image(image_u8),))

    def submit_gt(self, image_u8: np.ndarray, verb_id: int) -> Future:
        """Verb-conditioned entry → Future of ``{"noun_logits": (R, L)}``."""
        if "gt" not in self._queues:
            raise ValueError("artifact has no gt entry (format_version < 2)")
        return self._submit(
            "gt", (self._check_image(image_u8), np.int32(verb_id)))

    @staticmethod
    def _check_image(img) -> np.ndarray:
        img = np.asarray(img)
        if img.shape != (256, 256, 3) or img.dtype != np.uint8:
            raise ValueError(
                f"expected one (256, 256, 3) uint8 window, got "
                f"{img.shape} {img.dtype} (preprocess with "
                f"data.transforms.host_window)")
        return img

    def _submit(self, kind: str, payload) -> Future:
        if self._closed:
            raise RuntimeError("batcher is closed")
        fut: Future = Future()
        try:
            self._queues[kind].put_nowait((payload, fut, _now()))
        except queue.Full:
            with self._lock:
                self.stats["rejected"] += 1
            raise BatcherSaturated(
                f"{kind} queue full ({self.max_queue} pending); retry "
                f"later") from None
        with self._lock:
            self.stats["requests"] += 1
        return fut

    # ------------------------------------------------------------- admin

    def swap_fn(self, fn: Callable) -> None:
        """Hot-swap the served artifact.  In-flight dispatches finish on
        whichever fn they read; new dispatches use the new one.  The new
        artifact must serve the same entries (a gt queue cannot appear or
        vanish mid-flight)."""
        if ("gt" in self._queues) != (getattr(fn, "gt", None) is not None):
            raise ValueError(
                "replacement artifact must have the same entries "
                "(gt-verb) as the one it replaces")
        self._fn = fn

    def latency_stats(self) -> dict:
        """Per-entry latency percentiles (ms, submit -> result fan-out)
        over the most recent window of requests."""
        return {kind: ring.summary()
                for kind, ring in self._latency.items()}

    def queue_depth(self) -> dict:
        return {kind: q.qsize() for kind, q in self._queues.items()}

    # ---------------------------------------------------------- dispatch

    def _drain_and_serve(self, kind: str) -> None:
        """Serve everything still queued (close path), in max_batch groups."""
        q = self._queues[kind]
        leftovers = []
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        for lo in range(0, len(leftovers), self._max_batch):
            self._run(kind, leftovers[lo:lo + self._max_batch])

    def _dispatch_loop(self, kind: str) -> None:
        q = self._queues[kind]
        while True:
            try:
                first = q.get(timeout=0.1)
            except queue.Empty:
                if self._closed:
                    return
                continue
            if first is None:          # close sentinel
                # a submit racing close() may have landed behind the
                # sentinel — serve it rather than strand its Future
                self._drain_and_serve(kind)
                return
            batch = [first]
            saw_sentinel = False
            deadline = _now() + self._max_wait_s
            while len(batch) < self._max_batch:
                remaining = deadline - _now()
                try:
                    item = (q.get_nowait() if remaining <= 0
                            else q.get(timeout=remaining))
                except queue.Empty:
                    break
                if item is None:
                    # close() raced into this window: serve the batch,
                    # then drain.  (Not re-posted — a bounded queue can
                    # be full, and a blocking re-post from the only
                    # consumer would deadlock.)
                    saw_sentinel = True
                    break
                batch.append(item)
            self._run(kind, batch)
            if saw_sentinel:
                self._drain_and_serve(kind)
                return

    def _run(self, kind: str, batch) -> None:
        futs = [f for _, f, _ in batch]
        # read self._fn ONCE: a hot reload (swap_fn) racing this dispatch
        # must not split one batch across two artifacts, and the meta
        # attached to each row below must be the meta of the fn that
        # actually produced the logits (a request landing
        # mid-swap must not combine new logits with old label_list)
        fn = self._fn
        served_meta = getattr(fn, "meta", None)
        try:
            args = tuple(np.stack([p[i] for p, _, _ in batch])
                         for i in range(len(batch[0][0])))
            if kind == "argmax":
                verb_logits, verb_ids, noun_logits = fn(args[0])
                verb_logits = _host(verb_logits)
                verb_ids = _host(verb_ids)
                noun_logits = _host(noun_logits)
                rows = [{"verb_logits": verb_logits[i],
                         "verb_id": int(verb_ids[i]),
                         "noun_logits": noun_logits[i],
                         "served_meta": served_meta}
                        for i in range(len(batch))]
            else:
                noun_logits = _host(fn.gt(args[0], args[1]))
                rows = [{"noun_logits": noun_logits[i],
                         "served_meta": served_meta}
                        for i in range(len(batch))]
        except Exception as e:       # noqa: BLE001 — fan the error out
            for f in futs:
                f.set_exception(e)
            return
        with self._lock:
            self.stats["dispatches"] += 1
            self.stats["batched_examples"] += len(batch)
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(batch))
        done = _now()
        ring = self._latency[kind]
        for (_, f, t0), row in zip(batch, rows):
            ring.record((done - t0) * 1e3)
            f.set_result(row)

    def close(self) -> None:
        """Drain-and-stop: every request submitted before close() returns
        is still served (the dispatcher drains behind its sentinel, and a
        final synchronous drain here catches anything that slipped in
        while the threads were exiting).  Submitting concurrently with
        close() is a caller error; such a request is served on a
        best-effort basis or rejected by the _closed check."""
        self._closed = True
        for q in self._queues.values():
            q.put(None)
        for t in self._threads:
            t.join(timeout=30)
        for kind in self._queues:
            self._drain_and_serve(kind)


def _host(x) -> np.ndarray:
    """A served output (a tensor on any device, or an array) → numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _now() -> float:
    import time

    return time.monotonic()


class _LatencyRing:
    """Bounded ring of recent request latencies (ms) + lifetime count.

    A fixed-size window keeps /stats O(1)-memory under any uptime while
    still tracking the CURRENT latency profile (a lifetime histogram
    would freeze p95 at whatever a cold-start spike left behind)."""

    def __init__(self, window: int):
        from collections import deque

        self._ring = deque(maxlen=window)
        self._lock = threading.Lock()
        self._count = 0

    def record(self, ms: float) -> None:
        with self._lock:
            self._ring.append(ms)
            self._count += 1

    def summary(self) -> dict:
        with self._lock:
            vals = list(self._ring)
            count = self._count
        if not vals:
            return {"count": 0}
        arr = np.asarray(vals)
        return {
            "count": count,
            "window": len(vals),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p95_ms": round(float(np.percentile(arr, 95)), 3),
            "p99_ms": round(float(np.percentile(arr, 99)), 3),
            "max_ms": round(float(arr.max()), 3),
        }


# ------------------------------------------------------------------ HTTP

def _warm(fn) -> None:
    """Run one zero batch through each entry of ``fn`` so the kernel
    builds and first launches happen before the artifact takes traffic
    (used at startup and on hot reload; the loader pads every dispatch to
    the baked batch size, so this one call covers all request shapes)."""
    meta = getattr(fn, "meta", {})
    baked = int(getattr(fn, "batch_size", 0) or meta.get("batch_size", 1))
    zeros = np.zeros((baked, 256, 256, 3), np.uint8)
    _host(fn(zeros)[1])
    gt = getattr(fn, "gt", None)
    if gt is not None:
        _host(gt(zeros, np.zeros((baked,), np.int32)))


def _decode_body(body: bytes) -> np.ndarray:
    """Image bytes (JPEG/PNG/...) → eval window, exactly the dataset's
    eval preprocessing (PIL decode → RGB → host_window center crop)."""
    import io

    from PIL import Image

    from situation_recognition_tpu_torch.data.transforms import host_window

    img = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
    return host_window(img, train=False)


def _display(label: str) -> str:
    # reference display rule: ''/'UNK' → '-' (sr.py:274-279)
    return "-" if label in ("", "UNK") else label


def _softmax(x: np.ndarray) -> np.ndarray:
    """Numerically stable softmax over the last axis, in float64."""
    x = np.asarray(x, np.float64)
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return e / np.sum(e, axis=-1, keepdims=True)


def _role_rows(meta: dict, verb: str, noun_logits: np.ndarray):
    """Per-role argmax nouns for ``verb``, named via meta['roles_per_verb']
    when the artifact carries it (format v6+)."""
    label_list = meta.get("label_list", [])
    roles = (meta.get("roles_per_verb") or {}).get(verb)
    nslots = len(roles) if roles else noun_logits.shape[0]
    rows = []
    for r in range(min(nslots, noun_logits.shape[0])):
        lab = int(np.argmax(noun_logits[r]))
        probs = _softmax(noun_logits[r])
        rows.append({
            "role": roles[r] if roles else f"slot{r}",
            "label_id": lab,
            "label": _display(label_list[lab]) if label_list else str(lab),
            "prob": float(probs[lab]),
        })
    return rows


class _Handler:
    """Request logic, separated from BaseHTTPRequestHandler so it is unit-
    testable without sockets.  Returns (status, json-serializable body)."""

    def __init__(self, batcher: DynamicBatcher, meta: dict,
                 timeout_s: float = 60.0, reload_fn=None):
        self.batcher = batcher
        self.timeout_s = timeout_s
        self.reload_fn = reload_fn      # path -> loaded artifact, or None
        # (meta, verb_index) live in ONE attribute so a hot reload swaps
        # them atomically — a predict landing mid-swap unpacks a
        # consistent pair instead of combining the new verb index with
        # the old meta
        self._served = (meta, {v: i for i, v in
                               enumerate(meta.get("verb_list", []))})

    @property
    def meta(self) -> dict:
        return self._served[0]

    def get(self, path: str):
        if path == "/healthz":
            return 200, {"status": "ok"}
        if path == "/stats":
            stats = dict(self.batcher.stats)
            stats["queue_depth"] = self.batcher.queue_depth()
            stats["latency_ms"] = self.batcher.latency_stats()
            return 200, stats
        if path == "/meta":
            m = {k: v for k, v in self.meta.items()
                 if k not in ("verb_list", "label_list", "roles_per_verb")}
            m["num_verbs"] = self.meta.get(
                "num_verbs", len(self.meta.get("verb_list", [])))
            return 200, m
        return 404, {"error": f"unknown path {path}"}

    def predict(self, body: bytes, verb: Optional[str] = None):
        if not body:
            return 400, {"error": "empty body (POST the image bytes)"}
        try:
            window = _decode_body(body)
        except Exception as e:       # noqa: BLE001
            return 400, {"error": f"could not decode image: {e}"}
        import concurrent.futures as cf

        try:
            return self._predict_decoded(window, verb)
        except BatcherSaturated as e:
            # backpressure, not failure: the client should retry
            return 429, {"error": str(e), "retry": True}
        # both spellings: cf.TimeoutError only aliases the builtin from
        # Python 3.11 — on 3.10 (supported per pyproject) they differ
        except (TimeoutError, cf.TimeoutError):
            return 504, {"error": f"inference timed out after "
                                  f"{self.timeout_s}s"}
        except Exception as e:       # noqa: BLE001 — JSON, not a dropped
            return 500, {"error": f"inference failed: {e}"}  # connection

    def reload(self, body: bytes):
        """POST /admin/reload {"artifact": <dir>} — hot-swap the served
        artifact without dropping in-flight requests.  Disabled unless
        serve_http(..., allow_reload=True) (an admin surface must be
        opted into, not ambient)."""
        if self.reload_fn is None:
            return 403, {"error": "reload disabled (start with "
                                  "allow_reload=True)"}
        try:
            req = json.loads(body or b"{}")
            path = req["artifact"]
        except (ValueError, KeyError):
            return 400, {"error": 'body must be {"artifact": "<dir>"}'}
        try:
            fn = self.reload_fn(path)
            # warm the replacement BEFORE it starts taking traffic: the
            # first dispatch after a cold swap would otherwise pay the
            # kernel build — the cold-start 504 serve_http's warmup
            # exists to prevent
            _warm(fn)
            new_meta = getattr(fn, "meta", {})
            new_state = (new_meta, {v: i for i, v in
                                    enumerate(new_meta.get("verb_list", []))})
            self.batcher.swap_fn(fn)
        except Exception as e:       # noqa: BLE001 — keep serving old fn
            return 400, {"error": f"reload failed, still serving the "
                                  f"previous artifact: {e}"}
        self._served = new_state     # single atomic assignment
        return 200, {"status": "reloaded", "artifact": path,
                     "format_version": new_meta.get("format_version")}

    def _predict_decoded(self, window, verb: Optional[str]):
        meta, verb_index = self._served    # one consistent pair
        if verb is not None:
            # the reference's gt path: a given-and-valid verb is used with
            # probability 1 (sr.py:249-251); an unknown verb is an error
            # here (the CLI's "calculating by myself" fallback belongs to
            # the CLI; an API should not silently ignore an argument)
            if verb not in verb_index:
                return 400, {"error": f"unknown verb {verb!r}"}
            if "gt" not in self.batcher._queues:
                # capability of the artifact, not a server fault
                return 400, {"error": "artifact has no gt-verb entry "
                                      "(format_version < 2); re-export"}
            vid = verb_index[verb]
            fut = self.batcher.submit_gt(window, vid)
            row = fut.result(timeout=self.timeout_s)
            # map labels through the meta of the fn that actually served
            # the dispatch — a reload between submit and dispatch would
            # otherwise pair new logits with the old label_list
            meta = row.get("served_meta") or meta
            return 200, {
                "verb": verb, "verb_id": vid, "verb_prob": 1.0,
                "roles": _role_rows(meta, verb, row["noun_logits"]),
            }
        fut = self.batcher.submit(window)
        row = fut.result(timeout=self.timeout_s)
        meta = row.get("served_meta") or meta
        vid = row["verb_id"]
        vlist = meta.get("verb_list", [])
        vname = vlist[vid] if vid < len(vlist) else str(vid)
        return 200, {
            "verb": vname, "verb_id": vid,
            "verb_prob": float(_softmax(row["verb_logits"])[vid]),
            "roles": _role_rows(meta, vname, row["noun_logits"]),
        }


def serve_http(artifact, host: str = "127.0.0.1", port: int = 8000,
               max_wait_ms: float = 5.0, max_batch: Optional[int] = None,
               device=None, warmup: bool = True, max_queue: int = 256,
               allow_reload: bool = False):
    """Start the HTTP serving daemon; returns the ``ThreadingHTTPServer``
    (serve_forever runs on a daemon thread — call ``.shutdown()`` to stop).

    ``artifact``: an artifact directory path (loaded via
    ``serving.load_inference`` on ``device``) or an
    already-loaded callable with ``.meta``.

    ``warmup``: run one zero batch through each entry before accepting
    traffic.  The loader pads every dispatch to the artifact's baked batch
    size, so this one call covers all request shapes — without it the
    first request pays the kernel build (seconds on a cold
    host) and can time out its HTTP client.

    ``max_queue``: per-entry admission bound; requests beyond it get 429
    (see :class:`BatcherSaturated`).  ``allow_reload``: enable
    ``POST /admin/reload {"artifact": dir}`` hot-swapping.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    if isinstance(artifact, str):
        from situation_recognition_tpu_torch.serving import load_inference

        fn = load_inference(artifact, device=device)
    else:
        fn = artifact
    meta = getattr(fn, "meta", {})
    if warmup:
        _warm(fn)
    batcher = DynamicBatcher(fn, max_batch=max_batch,
                             max_wait_ms=max_wait_ms, max_queue=max_queue)
    reload_fn = None
    if allow_reload:
        from situation_recognition_tpu_torch.serving import load_inference as _li

        def reload_fn(path):
            return _li(path, device=device)
    logic = _Handler(batcher, meta, reload_fn=reload_fn)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet: ops read /stats instead
            pass

        def _send(self, status: int, payload: dict) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):            # noqa: N802 (http.server API)
            self._send(*logic.get(urlparse(self.path).path))

        def do_POST(self):           # noqa: N802
            u = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b""
            if u.path == "/admin/reload":
                self._send(*logic.reload(body))
                return
            if u.path not in ("/predict", "/v1/predict"):
                self._send(404, {"error": f"unknown path {u.path}"})
                return
            verb = (parse_qs(u.query).get("verb") or [None])[0]
            self._send(*logic.predict(body, verb=verb))

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.batcher = batcher
    t = threading.Thread(target=httpd.serve_forever,
                         name="srtorch-http", daemon=True)
    t.start()
    return httpd


def main(argv=None) -> None:
    """``python -m situation_recognition_tpu_torch.server <artifact>``."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve an exported artifact over HTTP with dynamic "
                    "micro-batching")
    ap.add_argument("artifact", help="artifact directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="batching window a lone request waits")
    ap.add_argument("--max_batch", type=int, default=None,
                    help="cap per dispatch (default: the artifact's baked "
                         "batch size)")
    ap.add_argument("--max_queue", type=int, default=256,
                    help="per-entry admission bound; overload gets 429")
    ap.add_argument("--allow_reload", action="store_true",
                    help="enable POST /admin/reload artifact hot-swap")
    args = ap.parse_args(argv)
    httpd = serve_http(args.artifact, host=args.host, port=args.port,
                       max_wait_ms=args.max_wait_ms,
                       max_batch=args.max_batch, device=args.device,
                       max_queue=args.max_queue,
                       allow_reload=args.allow_reload)
    host, port = httpd.server_address[:2]
    print(f"serving {args.artifact} on http://{host}:{port}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.batcher.close()


if __name__ == "__main__":
    main()
