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

The command line serves an export of either package (``tools/export.py``)
or a run dir of either package's ``tools/train.py``, on the card unless
``--device cpu``; the JAX CLI's flags, plus ``--device``::

    python -m motiondiffusion_moe_tpu_torch.tools.serve \
        --export_dir checkpoints/demo/export --port 8980 \
        --sampler dpm --steps 20 --micro_batch 16

:func:`build_server` builds the pipeline and the unstarted server from the
arguments; :func:`main` serves it until interrupted (SIGINT or SIGTERM).

Over several devices (``--data_parallel``, ``--expert_parallel``,
``--tensor_parallel``: the JAX CLI's mesh, ``tools/serve.py:300-322`` of
the JAX package) the port runs one process per device, launched by
torchrun or with ``--coordinator_address / --num_processes /
--process_id`` (the backend follows the device: NCCL on CUDA); the
process group must have ``dp x ep x tp`` ranks, and in one process a
degree above 1 raises ``ValueError``. Each rank loads its shard of the
export or run dir, in turns of as many ranks as host memory holds
(``parallel/distributed.py::in_turn``). Rank 0
binds the HTTP front end and runs the batcher; every generation (a merged
batch or a seeded request) goes to all ranks as one job
(``pipeline.MeshLeader``), which they sample together. A deadline that
passes while a job runs answers 504 on rank 0 and the ranks finish the job;
a request still queued is cancelled before it is sent. ``/healthz`` is
rank 0's. Stopping rank 0 stops every rank; a rank that fails stops rank
0's server, which then exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from motiondiffusion_moe_tpu_torch.parallel.mesh import add_launch_flags


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


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--export_dir",
                     help="serving artifact from either package's "
                          "tools/export.py")
    src.add_argument("--run_dir",
                     help="a training run dir of either package "
                          "(config.json + ckpt/)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8980)
    p.add_argument("--sampler", default="ddim",
                   choices=["ddpm", "ddim", "dpm"])
    p.add_argument("--steps", type=int, default=50,
                   help="inference steps (0 = full schedule)")
    p.add_argument("--micro_batch", type=int, default=8)
    p.add_argument("--max_batch", type=int, default=64)
    p.add_argument("--max_queue", type=int, default=256,
                   help="queued-prompt bound; past it requests shed with "
                        "503 + Retry-After")
    p.add_argument("--request_timeout", type=float, default=120.0,
                   help="per-request deadline in seconds (504 past it; "
                        "0 disables)")
    p.add_argument("--use_ema", action="store_true",
                   help="(--run_dir only) serve the EMA weights")
    p.add_argument("--param_dtype", default="", choices=["", "bfloat16"],
                   help="serving weight dtype (see GenerationPipeline)")
    p.add_argument("--no_denormalize", action="store_true",
                   help="return normalized feature space")
    p.add_argument("--warmup", action="store_true",
                   help="run one generation before binding")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda by default; cpu "
                        "only when asked)")
    add_launch_flags(p)
    return p


def build_pipeline(args, mesh, device):
    """The pipeline of the parsed arguments on ``device``; under a mesh the
    rank's shard of it, the ranks loading in turn."""
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.export import (
        artifact_bytes, load_run)

    kw = dict(sampler=args.sampler, num_inference_steps=args.steps or None,
              micro_batch=args.micro_batch,
              param_dtype=args.param_dtype or None, device=device, mesh=mesh)

    def load():
        if args.export_dir:
            return GenerationPipeline.from_export(args.export_dir, **kw)
        from motiondiffusion_moe_tpu_torch.data.normalizer import (
            MotionNormalizer)

        cfg, sd, step, normalizer = load_run(args.run_dir,
                                             use_ema=args.use_ema, mesh=mesh)
        pipe = GenerationPipeline(cfg, params=sd, **kw)
        pipe.normalizer = normalizer or MotionNormalizer.identity(
            cfg.data.dim_pose)
        print(f"[serve] {args.run_dir} step {step} (ema={args.use_ema})")
        return pipe

    if mesh is None:
        return load()
    from motiondiffusion_moe_tpu_torch.parallel.distributed import in_turn

    return in_turn(load, artifact_bytes(args.export_dir or args.run_dir))


def build_server(argv=None) -> ThreadingHTTPServer | None:
    """The pipeline and the unstarted HTTP server for the command line
    ``argv`` (see :func:`build_argparser`); the server's pipeline is
    ``server.pipe`` (under a mesh a ``pipeline.MeshLeader``, whose
    ``stop()`` releases the other ranks). On a rank other than 0 it runs
    the jobs rank 0 sends and returns None once rank 0 stops."""
    from motiondiffusion_moe_tpu_torch.parallel.mesh import (
        launch_generation)
    from motiondiffusion_moe_tpu_torch.pipeline import MeshLeader

    args = build_argparser().parse_args(argv)
    mesh, device = launch_generation(args)
    pipe = build_pipeline(args, mesh, device)
    print(f"[serve] device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f"; rank {mesh.rank} of data {mesh.dp} x expert {mesh.ep} x "
             f"model {mesh.tp}" if mesh is not None else ""))
    if mesh is not None and mesh.rank:
        n = pipe.follow_jobs()
        print(f"[serve] rank {mesh.rank}: {n} jobs, stopped by rank 0")
        return None
    if mesh is not None:
        pipe = MeshLeader(pipe)
    if args.warmup:
        t0 = time.perf_counter()
        pipe.generate(["warmup"], [min(16, pipe.cfg.model.max_frames)])
        print(f"[serve] warmup run {time.perf_counter() - t0:.1f}s")
    server = make_server(pipe, args.host, args.port,
                         denormalize=not args.no_denormalize,
                         max_batch=args.max_batch, max_queue=args.max_queue,
                         request_timeout=args.request_timeout or None)
    server.pipe = pipe
    return server


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> None:
    import torch.distributed as dist

    try:
        server = build_server(argv)
        if server is None:  # a rank other than 0, stopped
            return
        pipe = server.pipe
        leader = getattr(pipe, "leader", None)
        if leader is not None:  # a failed rank stops the front end
            leader.on_failure = lambda e: threading.Thread(
                target=server.shutdown, daemon=True).start()
        signal.signal(signal.SIGTERM, _interrupt)
        print(f"[serve] listening on http://{server.server_address[0]}:"
              f"{server.server_address[1]} (sampler={pipe.sampler}, "
              f"steps={pipe.num_inference_steps}, "
              f"micro_batch={pipe.micro_batch})", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            print("[serve] shutting down")
        finally:
            server.server_close()
            if leader is not None:
                leader.stop()
        if leader is not None and leader.failed is not None:
            raise RuntimeError(f"[serve] a rank failed: {leader.failed!r}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
