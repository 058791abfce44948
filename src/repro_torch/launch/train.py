"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The reference's flags plus ``--device`` (default: the CUDA device; pass
``--device cpu`` to run on the CPU). Without ``--full`` the config is its
reduced smoke variant (``configs.reduced``). ``--mesh`` (the reference's
multi-pod hybrid-2D schedule) is refused: it is not in the port yet
(ROADMAP.md Queue 1 item 13c).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config, reduced
from repro_torch.train.loop import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--full", action="store_true", help="full config (needs a card's memory)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--mesh", default=None, help="refused: the multi-pod schedule is not in the port yet")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error("--mesh (the hybrid-2D pod schedule) is not in the port yet (ROADMAP.md Queue 1 item 13c)")

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    report = train(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq_len,
        tau=args.tau,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=50 if args.checkpoint_dir else 0,
        device=args.device,
    )
    print(f"arch={cfg.name} steps={report.steps} tokens/s={report.tokens_per_s:.0f}")
    print("losses:", " ".join(f"{l:.4f}" for l in report.losses))


if __name__ == "__main__":
    main()
