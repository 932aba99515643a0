"""Serving CLI of the PyTorch port: batched requests through the
continuous-batching scheduler.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 8 --slots 4
    python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
        --requests 12 --slots 4 --max-new 16 --device cpu

Takes the flags of ``repro.launch.serve`` and ``--device`` (default: the
card; ``cpu`` runs the same model on the CPU).  Weights come from the
port's seeded initialisation (``--seed``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request, Scheduler


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = Model(cfg, device=args.device, seed=args.seed)
    print(f"[serve] {cfg.name}: {model.n_params()/1e6:.1f}M params, "
          f"{args.slots} slots on {model.device}", flush=True)

    engine = Engine(model, batch=args.slots, cache_len=args.cache_len)
    sched = Scheduler(engine)

    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    for r in range(args.requests):
        plen = rng.randint(args.prompt_len // 2, args.prompt_len + 1)
        prompt = rng.randint(0, cfg.vocab, size=(plen,)).astype(np.int32)
        sched.submit(Request(rid=r, prompt=prompt,
                             max_tokens=args.max_new))
    done = sched.run()
    _sync(model.device)
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done.values())
    print(f"[serve] {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens/dt:.1f} tok/s, "
          f"{sched.ticks} ticks)")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}: {done[rid].output[:8]}...")
    return 0


if __name__ == "__main__":
    main()
