"""Summarize a sustained training run (soak) from its train-CLI logs.

A copy of ``motiondiffusion_moe_tpu/tools/soak_report.py`` (log parsing on
the host, no device, so no ``--device``), kept in the port so that it
imports nothing of the JAX package. It reads the lines that
``utils/logging.py::print_current_loss`` prints for the port's
``tools/train.py`` (the same format as the JAX CLI's).

The soak protocol: >=500 optimizer steps at the flagship config, EMA,
checkpoint mid-run, kill, resume from the checkpoint, finish. This tool
parses the two log halves, verifies the loss curve is finite/decreasing and
that the resumed half CONTINUES the first half's step counter and loss
level, and writes a small JSON summary.

    python -m motiondiffusion_moe_tpu_torch.tools.soak_report \
        --logs .soak/soak1.log .soak/soak2.log --out .soak_summary.json
"""

from __future__ import annotations

import argparse
import json
import re

# the MetricsLogger line: "epoch:   0 niter: 0000110 time: 21m 30s
# grad_norm: 0.49 loss_moe: 0.32 loss_mot_rec: 1.00 loss_total: 1.33"
_LINE = re.compile(
    r"epoch:\s*(\d+)\s+niter:\s*(\d+)\s+time:\s*(?:(\d+)h\s*)?"
    r"(?:(\d+)m\s*)?(\d+(?:\.\d+)?)s.*?loss_total:\s*([\d.eE+-]+)")


def parse_log(path: str):
    rows = []
    with open(path, errors="replace") as f:
        for line in f:
            m = _LINE.search(line)
            if not m:
                continue
            ep, it, hh, mm, ss, loss = m.groups()
            t = (int(hh or 0) * 3600 + int(mm or 0) * 60 + float(ss))
            rows.append({"epoch": int(ep), "step": int(it),
                         "elapsed_s": t, "loss": float(loss)})
    return rows


def summarize(halves):
    assert halves and all(halves), "empty soak log"
    steps = [r["step"] for h in halves for r in h]
    losses = [r["loss"] for h in halves for r in h]
    assert all(l == l and abs(l) != float("inf") for l in losses), \
        "non-finite loss in soak"
    # per-half sustained rate: steps covered / elapsed between first and
    # last log line (excludes init+compile before the first line)
    rates = []
    for h in halves:
        d_steps = h[-1]["step"] - h[0]["step"]
        d_t = h[-1]["elapsed_s"] - h[0]["elapsed_s"]
        rates.append(d_steps / d_t if d_t > 0 else 0.0)
    # Loss trend: medians of the first/last 5 lines, compared within a
    # noise band (2x the median absolute deviation of the whole series).
    # A single-endpoint comparison flips on plateau noise: a loss that
    # has converged before the first log line makes last-vs-first raw
    # lines a coin flip (1.3291 -> 1.3312 read as "increasing" on a
    # healthy plateaued run). What a soak must establish is "not diverging":
    # the trend is decreasing OR flat within observed noise.
    def med(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]
    m_all = med(losses)
    mad = med([abs(l - m_all) for l in losses])
    first5, last5 = med(losses[:5]), med(losses[-5:])
    out = {
        "halves": len(halves),
        "total_steps": steps[-1],
        # monotonic WITHIN each half; across the kill/resume boundary the
        # counter rolls back to the last checkpoint (bounded replay)
        "monotonic_steps": all(
            [r["step"] for r in h] == sorted(r["step"] for r in h)
            for h in halves),
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "loss_min": min(losses),
        "loss_median_first5": first5,
        "loss_median_last5": last5,
        "loss_noise_mad": mad,
        # decreasing-or-plateaued within noise (see comment above)
        "loss_decreasing": last5 <= first5 + max(1e-3, 2 * mad),
        "sustained_steps_per_s": rates,
    }
    if len(halves) > 1:
        # resume continuity: the second half picks up from the mid-run
        # CHECKPOINT (not step 0 — the reference's crash-resume semantics,
        # ddpm_trainer.py:302-305), and its loss level is within the first
        # half's recent band (curve continues, no re-descent from init)
        a, b = halves[-2], halves[-1]
        out["resume_step_continues"] = (
            b[0]["step"] > a[0]["step"]
            and b[0]["step"] >= a[-1]["step"] - 512)
        recent = [r["loss"] for r in a[-5:]]
        band = max(recent) - min(recent) + 0.05 * abs(recent[-1])
        out["resume_loss_gap"] = abs(b[0]["loss"] - recent[-1])
        out["resume_loss_continues"] = out["resume_loss_gap"] <= max(
            2 * band, 0.1 * abs(recent[-1]))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--logs", nargs="+", required=True,
                   help="log halves in order (pre-kill, post-resume)")
    p.add_argument("--out", default=".soak_summary.json")
    args = p.parse_args(argv)
    halves = [parse_log(p) for p in args.logs]
    halves = [h for h in halves if h]
    s = summarize(halves)
    with open(args.out, "w") as f:
        json.dump(s, f, indent=1)
    print(json.dumps(s, indent=1))


if __name__ == "__main__":
    main()
