"""Training launcher (port of repro.launch.train).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --smoke --steps 20 --ckpt-dir /tmp/ckpt --device cpu

Without --device the model, the data and the steps run on the card.
Weights are random, drawn from seed 0; the data is the TokenStream
(learnable synthetic tokens). One device, as in the reference, whose
launcher builds no mesh either: the sharded train step is
launch/steps.train_lowerable on a DeviceMesh.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import get_arch
from ..configs.smoke import smoke_config
from ..core.types import resolve_device
from ..data.tokens import TokenStream
from ..models import init_model
from ..train import Trainer, TrainerConfig, optim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--scan", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    cfg = smoke_config(arch.config) if args.smoke else arch.config
    if args.smoke:
        cfg = dataclasses.replace(cfg, scan_layers=args.scan)

    model = init_model(cfg, 0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    tcfg = TrainerConfig(
        opt=optim.AdamWConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps),
        microbatches=args.microbatches,
        checkpoint_every=max(10, args.steps // 4),
        ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, tcfg)

    stream = TokenStream(vocab=cfg.vocab_size, batch=args.batch,
                         seq=args.seq)

    def data(start):
        for b in stream.iter_from(start):
            yield {"tokens": torch.as_tensor(b["tokens"], device=dev)}

    trainer.fit(model, data, args.steps)
    first = trainer.history[0]["loss"] if trainer.history else float("nan")
    last = trainer.history[-1]["loss"] if trainer.history else float("nan")
    print(f"loss {first:.4f} -> {last:.4f} over {len(trainer.history)} steps"
          f" (stragglers flagged: {trainer.straggler.flagged})")


if __name__ == "__main__":
    main()
