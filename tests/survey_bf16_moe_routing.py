"""How often the tiny bf16 MoE denoiser behind deberta-tiny routes a token
differently in the port and in the JAX package, over many weight draws.

For each seed, the fixture of ``tests/test_torch_deberta_slice.py`` is drawn
anew (``random_params(..., seed=s)``, the head scaled by 0.1) and the
denoiser runs on that file's inputs in f32 and bf16 compute in both
packages. Per draw it prints, over the 4 MoE layers (144 token-routings):

- top-2 choices that differ: JAX bf16 vs JAX f32, port bf16 vs port f32,
  port bf16 vs JAX bf16;
- whether each port-vs-JAX difference is a near tie (the rule that
  ``test_motion_transformer_bf16[moe]`` holds);
- the relative RMS from JAX's bf16 output of the port's bf16 output on its
  own routing and routed as JAX routes, and JAX's own bf16-vs-f32 distance.

Then the totals, and the RMS of the router probabilities' bf16 movement
from f32 in each package. Run from the repository root (CPU, ~10 s a draw):

    python -m tests.survey_bf16_moe_routing --seeds 48
"""

import argparse

import numpy as np
import pytest

from tests import test_torch_deberta_slice as S
from tests._torch_parity import random_params, rel_rms


def _draw(seed):
    cfg = S._cfg()
    T, F = cfg.model.max_frames, cfg.model.input_feats
    params = random_params(S.JaxMotionTransformer(cfg.model),
                           np.zeros((S.MB, T, F), np.float32),
                           np.zeros(S.MB, np.int32),
                           np.full(S.MB, T, np.int32),
                           text_ids=S._ids(cfg), seed=seed)
    params["out"] = {k: 0.1 * v for k, v in params["out"].items()}
    return params


def _port_record(params, dtype, mp):
    """The port's output, and each MoE layer's top-2 choices and router
    probabilities, in ``dtype`` compute."""
    own = S.TM.top_k_lowest_index
    chosen, probs_seen = [], []

    def top_k(probs, k):
        vals, idx = own(probs, k)
        chosen.append(np.sort(idx.numpy(), -1))
        probs_seen.append(probs.numpy().copy())
        return vals, idx

    port = S.load_into(S.MotionTransformer(S.to_port(S._cfg(dtype).model)),
                       params)
    x, ts, lengths, ids = S._denoiser_inputs()
    with mp.context() as m, S.torch.no_grad():
        m.setattr(S.TM, "top_k_lowest_index", top_k)
        out = port(S.t(x), S.t(ts), S.t(lengths), text_ids=S.t(ids))
    return out.numpy(), chosen, probs_seen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=48)
    args = ap.parse_args(argv)
    mp = pytest.MonkeyPatch()
    tot = {"jax": 0, "port": 0, "port_vs_jax": 0, "n": 0}
    noise = {"jax": [], "port": []}
    rows = []
    for seed in range(1, args.seeds + 1):
        params = _draw(seed)
        ref, jax_b = S._jax_routed("bfloat16", params)
        ref32, jax_f = S._jax_routed("float32", params)
        out, port_b, q_b = _port_record(params, "bfloat16", mp)
        _, port_f, q_f = _port_record(params, "float32", mp)
        forced, _ = S._port_routed(params, mp,
                                   forced=[S._top2(p) for p in jax_b])
        n = {"jax": 0, "port": 0, "port_vs_jax": 0}
        near_ties = True
        for p_b, p_f, mine_b, mine_f in zip(jax_b, jax_f, port_b, port_f):
            differ = (mine_b != S._top2(p_b)).any(-1)
            n["jax"] += int((S._top2(p_b) != S._top2(p_f)).any(-1).sum())
            n["port"] += int((mine_b != mine_f).any(-1).sum())
            n["port_vs_jax"] += int(differ.sum())
            srt = -np.sort(-p_f, -1)
            gap = srt[:, 1] - srt[:, 2]
            near_ties &= bool(
                (gap[differ] <= 2 * np.abs(p_b - p_f).max()).all())
            tot["n"] += len(mine_b)
        noise["jax"] += [((a - b) ** 2).mean() for a, b in zip(jax_b, jax_f)]
        noise["port"] += [((a - b) ** 2).mean() for a, b in zip(q_b, q_f)]
        for k in n:
            tot[k] += n[k]
        row = (rel_rms(out, ref), rel_rms(forced, ref), rel_rms(ref, ref32))
        rows.append((n["port_vs_jax"],) + row)
        print(f"seed {seed}: top-2 differs jax bf16/f32 {n['jax']}, port "
              f"bf16/f32 {n['port']}, port/jax bf16 {n['port_vs_jax']} "
              f"(near ties: {near_ties}); relative RMS to JAX bf16: own "
              f"routing {row[0]:.3e}, JAX's routing {row[1]:.3e}; JAX bf16 "
              f"to f32 {row[2]:.3e}", flush=True)
    own, forced, jax_own = (np.array([r[i] for r in rows]) for i in (1, 2, 3))
    print(f"totals over {tot['n']} token-routings: {tot}")
    print(f"port/jax differences per draw: "
          f"{np.bincount([r[0] for r in rows]).tolist()} (draws with 0, 1, "
          f"...)")
    print(f"own routing: > 1.2e-2 on {int((own > 1.2e-2).sum())} draws, "
          f"> 1.5x JAX's own on {int((own > 1.5 * jax_own).sum())}, max "
          f"{own.max():.3e}")
    print(f"JAX's routing: median {np.median(forced):.3e}, > 1.2e-2 on "
          f"{int((forced > 1.2e-2).sum())} draws, at most "
          f"{(forced / jax_own).max():.3f}x JAX's own bf16-vs-f32 distance")
    print(f"router-probability RMS move, bf16 from f32: jax "
          f"{np.sqrt(np.mean(noise['jax'])):.4e}, port "
          f"{np.sqrt(np.mean(noise['port'])):.4e}")


if __name__ == "__main__":
    main()
