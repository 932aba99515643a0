"""Training entry point with fault tolerance (the port of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/run1
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --device cpu --steps 20 --batch 2 --seq 32

Takes the reference's flags and ``--device`` (default: the card; raises
without one; ``cpu`` trains the same model on the CPU).  Resumes
automatically from the newest checkpoint in --ckpt-dir; pair with
``launch/supervisor.py`` for restart-on-crash.  --crash-at-step N injects
a failure for the fault-tolerance test.  Data is counter-based synthetic,
so restarts replay the stream exactly.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.core.backend import resolve_device
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import Model
from repro_torch.models.params import state_from_reference
from repro_torch.train import step as step_lib
from repro_torch.train.checkpoint import CheckpointManager


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Train as the flags say.  Returns (the final state, one dict per step
    run: ``step``, the metrics as floats and ``ms``, the step's host time
    ending in a device synchronise)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--crash-at-step", type=int, default=-1,
                    help="fault injection for supervisor tests")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps, microbatch=args.microbatch,
                       optimizer=args.optimizer)
    model = Model(cfg, device=dev, seed=tcfg.seed)
    print(f"[train] {cfg.name}: {model.n_params()/1e6:.1f}M params on {dev}",
          flush=True)

    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=tcfg.seed)
    step_fn = step_lib.build_train_step(model, tcfg)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        tree, start = mgr.restore(step_lib.abstract_state(model, tcfg),
                                  device=dev)
        state = state_from_reference(model, tree)
        print(f"[train] resumed from step {start}", flush=True)
    else:
        state = step_lib.init_state(model, tcfg)

    marker = (os.path.join(args.ckpt_dir, ".crash_injected")
              if args.ckpt_dir else "")
    history = []
    t0 = time.time()
    for step in range(start, args.steps):
        if step == args.crash_at_step and not (
                marker and os.path.exists(marker)):
            # one-shot fault injection: mark so the restarted run proceeds
            if marker:
                with open(marker, "w") as f:
                    f.write(str(step))
            if mgr is not None:
                # the injection simulates a crash *after* the last
                # checkpoint became durable (what the restart test
                # verifies); without this join the daemon writer thread
                # races the exit and the restart may find no checkpoint
                mgr.wait()
            print(f"[train] injected crash at step {step}", flush=True)
            raise SystemExit(17)
        t_step = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        batch.update(_frontends(cfg, args.batch, dev))
        state, metrics = step_fn(state, batch)
        _sync(dev)
        history.append(dict({k: float(v) for k, v in metrics.items()},
                            step=step,
                            ms=(time.perf_counter() - t_step) * 1e3))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={history[-1]['loss']:.4f} "
                  f"gnorm={history[-1]['grad_norm']:.3f} "
                  f"lr={history[-1]['lr']:.2e} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            mgr.save(state, step + 1)          # async
    if mgr is not None:
        mgr.save(state, args.steps, blocking=True)
    print("[train] done", flush=True)
    return state, history


def _frontends(cfg, batch, device):
    out = {}
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        out["enc_embeds"] = torch.zeros(
            (batch, cfg.encoder_len, cfg.d_model), dtype=dt, device=device)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = torch.zeros(
            (batch, cfg.frontend_len, cfg.d_model), dtype=dt, device=device)
    return out


if __name__ == "__main__":
    main()
