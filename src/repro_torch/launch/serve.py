"""Serving launcher: batched decode with optional MicroNN RAG (port of
repro.launch.serve).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --rag

Without --device the model, the datastore and the decode run on the card.
Weights are random, drawn from seed 0 (no checkpoint is loaded).
"""
from __future__ import annotations

import argparse
import numpy as np
import torch

from ..configs import get_arch
from ..configs.smoke import smoke_config
from ..core import ivf
from ..core.rag import RagConfig, RagDatastore
from ..core.types import IVFConfig, resolve_device
from ..models import init_model
from ..serving import Request, ServeEngine


@torch.no_grad()
def build_rag_datastore(cfg, n: int = 2048, seed: int = 1, *,
                        device=None) -> RagDatastore:
    """n Gaussian context vectors of width d_model in an IVF index of ~64
    rows a partition, each with a random next token; ids 0..n-1 index
    `next_token`, whose entry n is spare (for an upsert). `device` None
    means the card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, cfg.d_model)).astype(np.float32)
    index = ivf.build_index(vecs, cfg=IVFConfig(
        dim=cfg.d_model, target_partition_size=64, kmeans_iters=20,
        delta_capacity=256), device=dev)
    next_tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, n + 1),
                               dtype=torch.int32, device=dev)
    return RagDatastore(index=index, next_token=next_tok)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b",
                    help="any of the ten registered archs or an alias "
                         "(its smoke config is served)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(get_arch(args.arch).config)
    model = init_model(cfg, 0, device=dev)
    rag = build_rag_datastore(cfg, device=dev) if args.rag else None
    eng = ServeEngine(cfg, model, slots=args.slots, s_max=64, rag=rag,
                      rag_cfg=RagConfig(k=8, n_probe=4, lam=0.3),
                      device=dev)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=list(map(int, rng.integers(1, 64, 5))),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while (eng.queue or any(s is not None for s in eng.active)) \
            and steps < 200:
        eng.step()
        steps += 1
    for r in reqs:
        print(f"req {r.uid}: prompt={r.prompt} -> out={r.out}"
              f" done={r.done}")
    print(f"served {len(reqs)} requests in {steps} engine steps"
          f" ({args.slots} slots, continuous batching"
          f"{', RAG' if args.rag else ''}) on {dev}")


if __name__ == "__main__":
    main()
