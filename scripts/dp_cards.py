"""Data-parallel training of the flagship over NCCL on the cards of one
host, one process each: ``chip_smoke.py`` phase M on real ranks.

    python3 scripts/dp_cards.py [--cards N]

Needs N CUDA cards (default: all). For world 1 and then N, the ranks of
``chip_smoke.py``'s M1 (``--m1-rank``), rank r on card r over NCCL: the
flagship at full width and depth, f32 compute, dropout 0, EMA, one global
batch of 32 at T = 196 with ragged lengths, each rank's step (ZeRO-1 off
and on) against the one-process step that rank 0 runs on its card, the
kernels' launches, the resident moments and EMA, peak memory and ms per
step; then 2 steps in bf16 compute with ZeRO-1, whose second step's ms at
world 1 and N (the same global batch) give the data-parallel speed-up.
Then ``chip_smoke.py``'s M2 on N cards: ``tools/train.py`` as N processes
over NCCL (``--data_parallel N --zero1``, the flagship's full width and
depth) and a one-process resume of its run dir on card 0. Exits non-zero
when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as C
    from motiondiffusion_moe_tpu_torch.config import ExperimentConfig
    from motiondiffusion_moe_tpu_torch.ops import _build

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=0,
                   help="cards to use (default: all of them)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("dp_cards: no CUDA device", file=sys.stderr)
        return 1
    cards = args.cards or torch.cuda.device_count()
    if cards > torch.cuda.device_count():
        print(f"dp_cards: {cards} cards asked, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    _build.library()  # once, before the ranks load it
    card = C.card_line()
    print(f"[dp_cards] {cards} x {card}; torch {torch.__version__}")
    cfg32 = C.m_config(ExperimentConfig.moe_small())
    steady = {}
    with tempfile.TemporaryDirectory() as root:
        params, batch = (os.path.join(root, n) for n in ("w.pt", "b.npz"))
        torch.save(C.build_flagship(cfg32).state_dict(), params)
        C.m_batch(cfg32, batch)
        for world in sorted({1, cards}):
            spec = {"init": f"file://{root}/rdv_{world}", "params": params,
                    "batch": batch, "out": root, "cfg": cfg32.to_dict(),
                    "device": "cuda", "world": world, "backend": "nccl",
                    "label": f"{world} ranks, one card each, over NCCL"}
            path = os.path.join(root, f"spec_{world}.json")
            with open(path, "w") as fh:
                json.dump(spec, fh)
            outs = C.spawn_ranks([[os.path.join(ROOT, "chip_smoke.py"),
                                   "--m1-rank", path, str(r)]
                                  for r in range(world)])
            for r, (rc, out) in enumerate(outs):
                print("".join(f"[world {world} rank {r}] {line}\n"
                              for line in out.splitlines() if line.strip()),
                      end="")
            C.check(all(rc == 0 for rc, _ in outs),
                    f"world {world}: ranks exited with "
                    f"{[rc for rc, _ in outs]}")
            res = [json.load(open(os.path.join(root, f"m1_rank{r}.json")))
                   for r in range(world)]
            for r, rr in enumerate(res):
                for case in ("replicated", "zero1", "bf16_zero1"):
                    C.check(rr[case]["ok"], f"world {world} rank {r} {case}")
            steady[world] = max(rr["bf16_zero1"]["ms"][-1] for rr in res)
        C.phase_m2(torch.device("cuda", 0), card, root,
                   devices=[f"cuda:{r}" for r in range(cards)],
                   layers=cfg32.model.num_layers)
    print(f"[dp_cards] bf16 ZeRO-1 step of the global batch of 32 (the "
          f"second step, the slowest rank): "
          + ", ".join(f"{w} card(s) {ms:.1f} ms" for w, ms in steady.items())
          + (f"; speed-up {steady[1] / steady[cards]:.2f}x on {cards} cards"
             if cards > 1 else "") + f" ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
