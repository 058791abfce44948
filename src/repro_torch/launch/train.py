"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

The reference's flags plus ``--device`` (default: the CUDA device; pass
``--device cpu`` to run on the CPU). Without ``--full`` the config is its
reduced smoke variant (``configs.reduced``). ``--mesh`` (e.g.
``2x1x2:pod,data,model``) runs the hybrid-2D schedule over one process a
mesh device: start them with ``torchrun --nproc-per-node N -m
repro_torch.launch.train ...`` (the default ``--init-method env://``), or
set ``RANK`` and ``WORLD_SIZE`` in each and pass ``--init-method
file:///path/to/store``. Rank 0 prints the tokens/s, on the card each
rank's ``max_memory_allocated`` (bytes), and the losses.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.loop import train


def _mesh(arg: str, device, backend: str | None, init_method: str):
    """Parse ``2x1x2:pod,data,model``, join (or reuse) the default process
    group — a launcher sets ``WORLD_SIZE`` and ``RANK`` — and build the
    mesh (which refuses, saying how to start the processes, without one).
    The backend is NCCL on the card and gloo on the CPU unless ``backend``
    names one; under NCCL the rank's card (``resolve_device``: one a rank)
    is made current before the mesh is built, so NCCL's communicators and
    DTensor use the card the rank's tensors live on. A failed join raises."""
    shape_s, axes_s = arg.split(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    axes = tuple(axes_s.split(","))
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        backend = backend or ("nccl" if resolve_device(device).type == "cuda" else "gloo")
        if init_method == "env://":
            dist.init_process_group(backend, init_method=init_method)
        else:
            dist.init_process_group(backend, init_method=init_method, rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        if backend == "nccl":
            card = resolve_device(device)
            torch.cuda.set_device(card if card.index is not None else resolve_device(None))
    return make_mesh(shape, axes, device=device)


def _peaks(mesh, device) -> list[int] | None:
    """``max_memory_allocated`` of every rank's card (rank 0's alone without
    a mesh); None on the CPU. Collective on a mesh."""
    if device.type != "cuda":
        return None
    mine = torch.tensor([torch.cuda.max_memory_allocated(device)], dtype=torch.int64, device=device)
    if mesh is None:
        return mine.tolist()
    every = mine.new_empty((dist.get_world_size(),))
    dist.all_gather_into_tensor(every, mine)
    return every.tolist()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--full", action="store_true", help="full config (needs a card's memory)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--mesh", default=None, help='e.g. "2x2:data,model" or "2x2x2:pod,data,model"')
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--backend", default=None, help="process-group backend with --mesh (default: nccl on "
                    "the card, gloo on the CPU; gloo for ranks that share a card)")
    ap.add_argument("--init-method", default="env://", help="process-group rendezvous with --mesh")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg)
    mesh = _mesh(args.mesh, args.device, args.backend, args.init_method) if args.mesh else None
    report = train(
        cfg,
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq_len,
        tau=args.tau,
        mesh=mesh,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=50 if args.checkpoint_dir else 0,
        device=args.device,
    )
    peaks = _peaks(mesh, resolve_device(args.device))
    if mesh is None or dist.get_rank() == 0:
        print(f"arch={cfg.name} steps={report.steps} tokens/s={report.tokens_per_s:.0f}"
              + ("" if peaks is None else f" max_memory_allocated={peaks}"))
        print("losses:", " ".join(f"{l:.4f}" for l in report.losses))
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
