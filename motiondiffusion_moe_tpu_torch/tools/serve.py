"""Minimal HTTP serving front-end for text-to-motion.

Port of ``_Batcher`` and ``make_server`` from
``motiondiffusion_moe_tpu/tools/serve.py`` around one
:class:`motiondiffusion_moe_tpu_torch.pipeline.GenerationPipeline`:

    POST /generate   {"texts": [...], "lengths": [...], "seed": 0,
                      "denormalize": true}
        -> {"motions": [[[...]...]], "shapes": [[len_i, D]], "step_ms": ...}
    GET  /healthz    -> {"ok": true, "sampler": ..., ...}

One generation runs at a time (one device lock). Requests WITHOUT a
``seed`` go through a dynamic batcher that merges everything queued while a
generation is in flight into ONE ``pipe.generate`` call; requests WITH a
``seed`` run alone with ``torch.Generator(device).manual_seed(seed)``, so
their output is a pure function of (texts, lengths, seed). Stdlib only.

The command-line entry (serving a flax export) waits for a reader of that
format that needs no flax.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


class _Batcher:
    """Dynamic request batching: coalesce queued seedless requests into
    one ``pipe.generate`` call (see module doc for why this is the
    device-friendly shape). One daemon worker owns the dispatch loop; each
    HTTP thread blocks on its request's event.
    """

    def __init__(self, pipe, lock: threading.Lock, max_batch: int,
                 max_queue: int = 256):
        self.pipe = pipe
        self.lock = lock
        self.max_batch = max_batch
        # queue DEPTH bound, in prompts: a sustained overload burst must
        # shed load (503) instead of growing memory and tail latency
        # without bound
        self.max_queue = max_queue
        self.last_call_s = 1.0  # drives the 503 Retry-After hint
        self._cv = threading.Condition()
        self._queue: list = []
        self._depth = 0  # prompts currently queued (not yet dispatched)
        # one stream for all merged calls, consumed call after call
        self._gen = torch.Generator(pipe.device).manual_seed(
            int(time.time_ns()) % (2 ** 31))
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, texts, lengths, timeout: float | None = None) -> dict:
        """Enqueue one request; blocks until its batch completes (or
        ``timeout`` seconds pass). Returns the request dict with one of:
        ``motions``+``batched`` (success), ``error`` (generation failed),
        ``overloaded`` (queue full — never enqueued), or ``timed_out``
        (deadline passed; cancelled if still queued, abandoned if already
        dispatched — the device program itself cannot be cancelled)."""
        req = {"texts": texts, "lengths": lengths,
               "event": threading.Event()}
        with self._cv:
            if self._depth + len(texts) > self.max_queue:
                req["overloaded"] = self._depth
                return req
            self._depth += len(texts)
            self._queue.append(req)
            self._cv.notify()
        if not req["event"].wait(timeout):
            with self._cv:
                if req in self._queue:  # still queued: cancel outright
                    self._queue.remove(req)
                    self._depth -= len(texts)
                    req["timed_out"] = "queued"
                    return req
            # already dispatched: result (or error) will arrive but the
            # caller's deadline has passed; report and drop it
            req["timed_out"] = "in_flight"
        return req

    def _loop(self):  # pragma: no branch - infinite worker
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
                # drain whole requests up to max_batch prompts; the rest
                # wait for the next call (never split one request)
                batch, n = [], 0
                while self._queue and (
                        n + len(self._queue[0]["texts"]) <= self.max_batch
                        or not batch):
                    r = self._queue.pop(0)
                    self._depth -= len(r["texts"])
                    batch.append(r)
                    n += len(r["texts"])
            texts = [t for r in batch for t in r["texts"]]
            lengths = [l for r in batch for l in r["lengths"]]
            t0 = time.perf_counter()
            try:
                with self.lock:
                    motions = self.pipe.generate(texts, lengths,
                                                 generator=self._gen)
                self.last_call_s = max(time.perf_counter() - t0, 1e-3)
            except Exception as e:  # pre-validated inputs: unexpected
                for r in batch:
                    r["error"] = e
                    r["event"].set()
                continue
            ofs = 0
            for r in batch:
                k = len(r["texts"])
                r["motions"] = motions[ofs:ofs + k]
                r["batched"] = n
                ofs += k
                r["event"].set()


def make_server(pipe, host: str = "127.0.0.1", port: int = 0,
                denormalize: bool = True,
                max_batch: int = 64, max_queue: int = 256,
                request_timeout: float | None = 120.0
                ) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around a ready pipeline.

    ``port=0`` binds an ephemeral port (tests); read it back from
    ``server.server_address[1]``. ``max_batch`` bounds one request's
    prompt count so a single caller can't queue an unbounded generation
    (and is the coalescing ceiling of the dynamic batcher). ``max_queue``
    bounds the batcher's TOTAL queued prompts — past it, requests shed
    with 503 + Retry-After instead of growing memory/latency without
    bound. ``request_timeout`` (seconds; None disables) is the per-
    request deadline: expired requests get 504, and are cancelled if
    still queued.
    """
    lock = threading.Lock()
    normalizer = getattr(pipe, "normalizer", None)
    batcher = _Batcher(pipe, lock, max_batch, max_queue=max_queue)

    class Handler(BaseHTTPRequestHandler):
        # quiet: one access-log line per request goes to stdout via
        # log_message; keep it (ops-friendly) but drop the default noise
        def log_message(self, fmt, *args):  # pragma: no cover - cosmetic
            print(f"[serve] {self.address_string()} {fmt % args}")

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, {
                "ok": True,
                "sampler": pipe.sampler,
                "micro_batch": pipe.micro_batch,
                "max_frames": pipe.cfg.model.max_frames,
                "device": str(pipe.device),
                "queue_depth": batcher._depth,
                "max_queue": max_queue,
            })

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                texts = req["texts"]
                lengths = req["lengths"]
                if not isinstance(texts, list) or not isinstance(
                        lengths, list):
                    raise ValueError("texts and lengths must be lists")
                if len(texts) > max_batch:
                    raise ValueError(
                        f"{len(texts)} prompts > max_batch {max_batch}")
                if len(texts) != len(lengths):
                    raise ValueError(f"{len(texts)} texts but "
                                     f"{len(lengths)} lengths")
                # validate lengths HERE, not inside the merged generate
                # call — a batched dispatch must never fail on one
                # request's bad input
                T = pipe.cfg.model.max_frames
                for i, l in enumerate(lengths):
                    if not 1 <= int(l) <= T:
                        raise ValueError(
                            f"lengths[{i}]={l} outside [1, max_frames={T}]")
                seed = req.get("seed")
                denorm = bool(req.get("denormalize", denormalize))
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                return self._reply(400, {"error": str(e)})
            t0 = time.perf_counter()
            retry_after = str(max(1, int(round(batcher.last_call_s))))
            if seed is None:
                # dynamic batching: merged with whatever else is queued
                done = batcher.submit(texts, lengths,
                                      timeout=request_timeout)
                if "overloaded" in done:
                    return self._reply(
                        503, {"error": f"queue full ({done['overloaded']} "
                                       f"prompts >= max_queue {max_queue})"},
                        headers={"Retry-After": retry_after})
                if "timed_out" in done:
                    return self._reply(
                        504, {"error": f"request deadline "
                                       f"({request_timeout}s) exceeded "
                                       f"({done['timed_out']})"})
                if "error" in done:
                    return self._reply(500, {"error": str(done["error"])})
                motions, batched = done["motions"], done["batched"]
            else:
                # explicit seed: bit-reproducible, runs alone. The lock
                # acquire honors the same deadline: a seeded flood must
                # shed too, not pile up threads behind the device lock
                if not lock.acquire(timeout=request_timeout or -1):
                    return self._reply(
                        503, {"error": "device busy past the "
                                       f"{request_timeout}s deadline"},
                        headers={"Retry-After": retry_after})
                try:
                    motions = pipe.generate(
                        texts, lengths, generator=torch.Generator(
                            pipe.device).manual_seed(int(seed)))
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
                finally:
                    lock.release()
                batched = len(texts)
            ms = 1e3 * (time.perf_counter() - t0)
            if denorm and normalizer is not None:
                motions = [normalizer.denormalize_np(m) for m in motions]
            self._reply(200, {
                "motions": [np.asarray(m).tolist() for m in motions],
                "shapes": [list(np.asarray(m).shape) for m in motions],
                "step_ms": round(ms, 2),
                "batched": batched,
            })

    return ThreadingHTTPServer((host, port), Handler)
