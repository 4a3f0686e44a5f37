"""Drive the PyTorch port's sampling and serving path once on one CUDA GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper GPU (the kernels are built with nvcc for sm_90a on
first use) and exits non-zero without one. Phases, each fatal on failure:

  setup  card name, count and power limit; build the CUDA kernels; TF32 off
         for matmuls and cuDNN.
  A      each hand-written kernel against its plain PyTorch version on the
         card, at the flagship shapes the main path gives it (B = 32 rows of
         the CFG-doubled micro-batch of 16, T = 196 and 98, ragged mask):
         favor_qkv in bf16 and f32, performer_epilogue in bf16; max errors
         against the stated tolerances; kernel and plain times per call
         (CUDA events over back-to-back calls) and device times
         (torch.profiler).
  B      the full-width flagship denoiser (ExperimentConfig.moe_small(),
         seeded init, zero-init leaves perturbed) forward once through the
         kernels and once with use_kernels=False, in f32 compute (tight
         tolerance) and in the flagship's bf16 compute (each path's distance
         from the f32 result: the kernels' may be no larger than 1.5x the
         plain bf16 path's, plus a small floor). Then 3 DPM-Solver++ steps
         for 2 prompts in f32 compute, through the kernels and without.
  C      GenerationPipeline(dpm, 20 steps, micro_batch 16, bf16 weights)
         behind make_server: /healthz, concurrent seedless requests merged by
         the batcher, mixed lengths, a seeded request twice (identical);
         finite motions of the right shapes, finite recover_from_ric; both
         kernels launched exactly 32 x (forwards) times. Then one ddim50 and
         one dpm20 generate of 16 prompts at 196 frames, timed.

The last line is {"ok": true, "device": {...}}, printed only when every
phase passed; the line before it lists the kernels of the path.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

SEED = 0
# bf16 kernel outputs are the f32 result rounded once: one bf16 ulp
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-3
F32_REL = 1e-4          # same f32 math, another summation order
# whole denoiser, kernels vs use_kernels=False. In f32 compute: the same
# math in another order. In bf16 compute the two paths round at different
# places (the plain path rounds to bf16 between the epilogue's steps), and
# near-tied MoE router probabilities then pick another expert for some
# tokens (top-2 is discontinuous), so both are held to the f32 result
# instead: the kernel path may be at most 1.5x as far from it as the plain
# bf16 path is, plus a floor for when the plain path happens to land close
DENOISER_F32_REL_RMS = 1e-4
DENOISER_BF16_FACTOR, DENOISER_BF16_FLOOR = 1.5, 5e-3
# 3 sampler steps in f32: the denoiser's ~1e-6 carried through guidance 7.5
# and the eps -> x0 factor sqrt(1/abar - 1) (~1.6e2 at t = 999)
SAMPLE_F32_REL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel_fn, plain_fn):
    """(kernel ms, plain ms) timed in turns: plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (time_ms(plain_fn), time_ms(kernel_fn),
                      time_ms(kernel_fn), time_ms(plain_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the sum of the CUDA kernels' own times
    that torch.profiler records over ``iters`` calls, divided by
    ``iters``. Unlike back-to-back CUDA events it leaves out the host's
    launch cost, which exceeds a short kernel's run time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "torch.profiler recorded no device time")
    return us / iters / 1e3


def ragged_mask(rng, B, T, dev):
    import torch

    lengths = rng.integers(1, T + 1, size=B)
    lengths[0] = T
    return torch.from_numpy((np.arange(T)[None] < lengths[:, None])
                            .astype(np.float32)).to(dev)


def phase_a(dev, card):
    import torch
    from motiondiffusion_moe_tpu_torch.ops import performer as P

    rng = np.random.default_rng(SEED)
    B, H, D, m, latent = 32, 4, 128, 128, 512
    results = {}

    def t(*shape, s=1.0, off=0.0):
        return torch.from_numpy((off + s * rng.standard_normal(shape))
                                .astype(np.float32)).to(dev)

    def report(name, dtype, T, out, ref):
        out, ref = out.float(), ref.float()
        check(bool(torch.isfinite(out).all()), f"{name} non-finite output")
        err = (out - ref).abs()
        max_abs = err.max().item()
        max_rel = (err / ref.abs().clamp_min(1e-6)).max().item()
        if dtype == torch.float32:
            tol = F32_REL * ref.abs().max().item()
            ok = max_abs <= tol
            tol_s = f"max_abs <= {F32_REL:g} * max|plain| = {tol:.3e}"
        else:
            ok = bool((err <= BF16_REL * ref.abs() + BF16_ABS).all())
            tol_s = f"|err| <= 2^-7 |plain| + {BF16_ABS:g} elementwise"
        print(f"[A] {name} {str(dtype)[6:]} B={B} T={T}: max_abs_err="
              f"{max_abs:.3e} max_rel_err={max_rel:.3e} tol: {tol_s} -> "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {dtype} T={T} outside tolerance")
        return max_abs

    for T in (196, 98):
        mask = ragged_mask(rng, B, T, dev)
        scale, bias = t(D, s=0.1, off=1.0), t(D, s=0.1)
        proj = t(D, m, s=D ** -0.25)
        for dtype in (torch.bfloat16, torch.float32):
            qkv = t(B, T, 3 * H * D).to(dtype)
            out = P.favor_qkv(qkv, scale, bias, proj, mask)
            torch.cuda.synchronize()
            ref = P.favor_qkv_plain(qkv, scale, bias, proj, mask)
            err = report("favor_qkv", dtype, T, out, ref)
            kernel = lambda: P.favor_qkv(qkv, scale, bias, proj, mask)
            plain = lambda: P.favor_qkv_plain(qkv, scale, bias, proj, mask)
            k_ms, p_ms = paired_ms(kernel, plain)
            print(f"[A] favor_qkv {str(dtype)[6:]} B={B} T={T}: kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call (CUDA "
                  f"events); device time kernel {device_ms(kernel):.4f} ms, "
                  f"plain {device_ms(plain):.4f} ms (torch.profiler) "
                  f"({card})")
            results[("favor_qkv", dtype, T)] = (err, k_ms, p_ms)

        y = t(B, T, latent).to(torch.bfloat16)
        sc = t(B, latent, s=0.3).to(torch.bfloat16)
        sh = t(B, latent, s=0.3).to(torch.bfloat16)
        vecs = [t(latent, s=0.1, off=1.0), t(latent, s=0.1),
                t(latent, s=0.1, off=1.0), t(latent, s=0.1)]
        out = P.performer_epilogue(y, sc, sh, *vecs)
        torch.cuda.synchronize()
        ref = P.performer_epilogue_plain(y, sc, sh, *vecs)
        err = report("performer_epilogue", torch.bfloat16, T, out, ref)
        kernel = lambda: P.performer_epilogue(y, sc, sh, *vecs)
        plain = lambda: P.performer_epilogue_plain(y, sc, sh, *vecs)
        k_ms, p_ms = paired_ms(kernel, plain)
        print(f"[A] performer_epilogue bfloat16 B={B} T={T}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms per call (CUDA events); "
              f"device time kernel {device_ms(kernel):.4f} ms, plain "
              f"{device_ms(plain):.4f} ms (torch.profiler) ({card})")
        results[("performer_epilogue", torch.bfloat16, T)] = (err, k_ms, p_ms)
    return results


def build_flagship(cfg):
    """The flagship denoiser on the CPU with seeded weights; the zero-init
    leaves (MoE gates, style-block output kernels, the head) get a small
    seeded draw, or the denoiser would output exactly zero."""
    import torch
    from motiondiffusion_moe_tpu_torch.models.layers import init_weights
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    model = init_weights(MotionTransformer(cfg.model), SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            zero_init = (name.endswith("gate.weight")
                         or name.endswith("out_kernel")
                         or name == "out.weight")
            if zero_init and not p.any():
                p.normal_(0.0, 0.02, generator=g)
    return model


def phase_b(cfg, model, dev):
    """One full-width forward through the kernels and one with
    use_kernels=False, in f32 compute (the kernels' own precision: tight)
    and in the flagship's bf16 compute, where both are held to the f32
    result: the kernels may cost no more than bf16 compute itself does."""
    import dataclasses

    import torch
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.models.transformer import (
        MotionTransformer)

    rng = np.random.default_rng(SEED + 2)
    B, T, F = 32, cfg.model.max_frames, cfg.model.input_feats
    x = torch.from_numpy(rng.standard_normal((B, T, F)).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 1000, size=B))
    length = torch.from_numpy(rng.integers(1, T + 1, size=B))
    length[0] = T
    prompts = [f"a person walks forward and turns {i}" for i in range(B // 2)]
    ids = torch.from_numpy(hash_tokenize(prompts + [""] * (B // 2),
                                         cfg.model.text_max_tokens))
    args = [a.to(dev) for a in (x, t, length)]

    def both(m):
        with torch.inference_mode():
            m.set_use_kernels(True)
            out_k = m(*args, text_ids=ids.to(dev))
            m.set_use_kernels(False)
            out_p = m(*args, text_ids=ids.to(dev))
            m.set_use_kernels(True)
        torch.cuda.synchronize()
        for out in (out_k, out_p):
            check(out.shape == (B, T, F), f"denoiser output {out.shape}")
            check(bool(torch.isfinite(out).all()), "denoiser non-finite")
        return out_k, out_p

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    cfg32 = dataclasses.replace(cfg.model, dtype="float32")
    m32 = MotionTransformer(cfg32).to(dev).eval()
    m32.load_state_dict(model.state_dict())
    k32, ref = both(m32)
    sample_f32_through_both(cfg, m32, dev, rng)
    del m32
    rel = rel_rms(k32, ref)
    ok = rel <= DENOISER_F32_REL_RMS
    print(f"[B] flagship denoiser float32 compute B={B} T={T}: kernels vs "
          f"use_kernels=False rel_rms={rel:.3e} max_abs="
          f"{(k32 - ref).abs().max().item():.3e} (|out| rms "
          f"{ref.pow(2).mean().sqrt().item():.3e}); tol rel_rms <= "
          f"{DENOISER_F32_REL_RMS:g} -> {'ok' if ok else 'FAIL'}")
    check(ok, "denoiser (float32) kernels vs plain")

    k16, p16 = both(model)
    err_k, err_p = rel_rms(k16, ref), rel_rms(p16, ref)
    tol = DENOISER_BF16_FACTOR * err_p + DENOISER_BF16_FLOOR
    ok = err_k <= tol
    print(f"[B] flagship denoiser bfloat16 compute B={B} T={T}: rel_rms to "
          f"the f32 result: kernels {err_k:.3e}, use_kernels=False "
          f"{err_p:.3e}; kernels vs use_kernels=False "
          f"{rel_rms(k16, p16):.3e}; tol kernels <= "
          f"{DENOISER_BF16_FACTOR:g} x use_kernels=False + "
          f"{DENOISER_BF16_FLOOR:g} = {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    check(ok, "denoiser (bfloat16) kernels vs plain")


def sample_f32_through_both(cfg, m32, dev, rng):
    """The whole sampler on a small input at full width: 3 DPM-Solver++
    steps for 2 prompts in f32 compute, through the kernels and through
    their plain versions, from the same injected noise."""
    import dataclasses

    import torch
    from motiondiffusion_moe_tpu_torch.models.text_encoder import (
        hash_tokenize)
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline

    T, F = cfg.model.max_frames, cfg.model.input_feats
    pipe = GenerationPipeline(dataclasses.replace(cfg, model=m32.config),
                              m32, sampler="dpm", num_inference_steps=3,
                              micro_batch=2, device=dev)
    tok = cfg.model.text_max_tokens
    ids_c = torch.from_numpy(hash_tokenize(["a person walks", "a person "
                                            "jumps twice"], tok))
    ids_u = torch.from_numpy(hash_tokenize(["", ""], tok))
    noise = torch.from_numpy(rng.standard_normal((2, T, F)).astype(
        np.float32))
    lengths = torch.tensor([T, 77])
    outs = []
    for flag in (True, False):
        m32.set_use_kernels(flag)
        outs.append(pipe.sample(ids_c, ids_u, lengths, noise=noise))
    m32.set_use_kernels(True)
    torch.cuda.synchronize()
    out_k, out_p = outs
    check(out_k.shape == (2, T, F) and bool(torch.isfinite(out_k).all()),
          "f32 sample shape or non-finite")
    err = (out_k - out_p).abs().max().item()
    tol = SAMPLE_F32_REL * out_p.abs().max().item()
    ok = err <= tol
    print(f"[B] flagship dpm3 sample, 2 prompts, float32 compute: kernels vs "
          f"use_kernels=False max_abs={err:.3e} (max|sample| "
          f"{out_p.abs().max().item():.3e}); tol {SAMPLE_F32_REL:g} x "
          f"max|sample| = {tol:.3e} -> {'ok' if ok else 'FAIL'}")
    check(ok, "f32 sample kernels vs plain")


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def phase_c(cfg, model, dev, card):
    import torch
    from motiondiffusion_moe_tpu_torch.data.normalizer import (
        MotionNormalizer)
    from motiondiffusion_moe_tpu_torch.motion.recover import recover_from_ric
    from motiondiffusion_moe_tpu_torch.ops import performer as P
    from motiondiffusion_moe_tpu_torch.pipeline import GenerationPipeline
    from motiondiffusion_moe_tpu_torch.tools.serve import make_server

    pipe = GenerationPipeline(cfg, model, sampler="dpm",
                              num_inference_steps=20, micro_batch=16,
                              param_dtype="bfloat16", device=dev)
    pipe.normalizer = MotionNormalizer.identity(cfg.data.dim_pose)
    T, F = cfg.model.max_frames, cfg.model.input_feats
    samples = []
    sample = pipe.sample

    def counted_sample(*a, **k):
        samples.append(1)
        return sample(*a, **k)

    pipe.sample = counted_sample
    # warm-up outside the counted run (cuBLAS / cuDNN handles, allocator)
    pipe.generate(["warm up"], [T])
    samples.clear()

    srv = make_server(pipe, port=0, max_batch=64)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        P.favor_qkv.launches = 0
        P.performer_epilogue.launches = 0
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health.get("ok") is True, f"/healthz {health}")
        print(f"[C] /healthz {health}")

        results = {}

        def post_into(key, payload):
            results[key] = _post(url + "/generate", payload)

        # A occupies the device; B and C arrive while it runs and are merged
        first = threading.Thread(target=post_into, args=(
            "a", {"texts": ["a person runs in a circle"] * 4,
                  "lengths": [T] * 4}))
        first.start()
        time.sleep(0.05)
        pair = [threading.Thread(target=post_into, args=(k, {
            "texts": [txt], "lengths": [n]})) for k, txt, n in (
                ("b", "a person waves with the left hand", 120),
                ("c", "a person jumps twice", 64))]
        for th2 in pair:
            th2.start()
        for th2 in [first] + pair:
            th2.join(timeout=600)
            check(not th2.is_alive(), "request thread hung")
        mixed_lens = [1, 57, 98, 196, 133]
        post_into("mixed", {"texts": ["walk", "kick the ball hard", "",
                                      "dance slowly", "sit down"],
                            "lengths": mixed_lens})
        seeded = {"texts": ["a person bows", "a person climbs stairs"],
                  "lengths": [150, 196], "seed": 1234}
        post_into("s1", seeded)
        post_into("s2", seeded)

        expect = {"a": [T] * 4, "b": [120], "c": [64], "mixed": mixed_lens,
                  "s1": [150, 196], "s2": [150, 196]}
        for key, lens in expect.items():
            status, body = results[key]
            check(status == 200, f"request {key}: HTTP {status}")
            motions = [np.asarray(mo, dtype=np.float32)
                       for mo in body["motions"]]
            check([list(mo.shape) for mo in motions] == [[n, F] for n in lens],
                  f"request {key}: shapes {body['shapes']}")
            check(all(np.isfinite(mo).all() for mo in motions),
                  f"request {key}: non-finite motion")
            joints = [recover_from_ric(torch.from_numpy(mo).to(dev),
                                       cfg.data.num_joints) for mo in motions]
            check(all(bool(torch.isfinite(j).all()) for j in joints),
                  f"request {key}: non-finite joints")
            rms = np.sqrt(np.mean(np.concatenate(
                [mo.ravel() for mo in motions]) ** 2))
            print(f"[C] request {key}: HTTP 200, shapes {body['shapes']}, "
                  f"batched={body['batched']}, step_ms={body['step_ms']}, "
                  f"motion rms {rms:.3f}, joints {tuple(joints[0].shape)} "
                  "finite")
        check(results["b"][1]["batched"] == 2
              and results["c"][1]["batched"] == 2,
              "the batcher did not merge the two concurrent requests")
        check(results["s1"][1]["motions"] == results["s2"][1]["motions"],
              "seeded repeats differ")
        print("[C] concurrent seedless requests merged into one call; "
              "seeded repeats identical")
        fwd = len(samples) * pipe.forwards_per_sample
        n_perf = 2 * 2 * cfg.model.num_layers  # Performers per forward
        launches = {"favor_qkv": P.favor_qkv.launches,
                    "performer_epilogue": P.performer_epilogue.launches}
        print(f"[C] {len(samples)} micro-batch samples x "
              f"{pipe.forwards_per_sample} forwards = {fwd} forwards; "
              f"launches {launches}; expected {n_perf} x {fwd} = "
              f"{n_perf * fwd} each")
        for name, n in launches.items():
            check(n == n_perf * fwd, f"{name} launched {n} times, expected "
                                     f"{n_perf * fwd}")
    finally:
        srv.shutdown()
        srv.server_close()
    pipe.sample = sample

    prompts = [f"a person performs action number {i}" for i in range(16)]
    timings = {}
    for name, sampler, steps in (("dpm20", "dpm", 20), ("ddim50", "ddim", 50)):
        p2 = GenerationPipeline(cfg, model, sampler=sampler,
                                num_inference_steps=steps, micro_batch=16,
                                param_dtype="bfloat16", device=dev)
        p2.generate(prompts, [T] * 16)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = p2.generate(prompts, [T] * 16,
                          generator=torch.Generator(dev).manual_seed(7))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        check(all(np.isfinite(o).all() for o in out), f"{name} non-finite")
        timings[name] = s
        print(f"[C] {name} generate 16 prompts x {T} frames (CFG, micro_batch "
              f"16, bf16 weights): {s:.3f} s, {s / 16:.4f} s/motion, "
              f"{16 / s:.2f} motions/s ({card})")
    return launches, timings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from motiondiffusion_moe_tpu.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.ops import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    print(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {name} x{count}")
    print(card)
    t0 = time.perf_counter()
    _build.library()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.1f} s, "
          f"cached={_build.build_info.get('cached')})")
    for line in _build.build_info.get("ptxas", []):
        if "registers" in line or "spill" in line:
            print(f"[setup] {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    a = phase_a(dev, card)

    cfg = ExperimentConfig.moe_small()
    t0 = time.perf_counter()
    model = build_flagship(cfg).to(dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[B] flagship moe_small: {n_params} parameters, seeded init + "
          f"perturbed zero-init leaves in {time.perf_counter() - t0:.1f} s")
    phase_b(cfg, model, dev)

    launches, _ = phase_c(cfg, model, dev, card)

    replaces = {
        "favor_qkv": ("motiondiffusion_moe_tpu_torch/csrc/favor_qkv.cu",
                      "motiondiffusion_moe_tpu/ops/performer_pallas.py:358"),
        "performer_epilogue": (
            "motiondiffusion_moe_tpu_torch/csrc/performer_epilogue.cu",
            "motiondiffusion_moe_tpu/ops/performer_pallas.py:657"),
    }
    kernels = []
    for kname, (src, rep) in replaces.items():
        err, k_ms, p_ms = a[(kname, torch.bfloat16, 196)]
        kernels.append({"name": kname, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[kname],
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms})
    check(all(math.isfinite(k["ms"]) for k in kernels), "kernel times")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
