"""End-to-end training launcher (reference: ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch mamba2-130m --steps 200 --batch 8 --seq 256 \
        --ckpt-dir /tmp/run1 [--grad-accum 2] [--compress] [--smoke] \
        [--device cpu]

One process on one device: the card by default (raises without one), the
CPU with ``--device cpu``. Fault tolerance: atomic async checkpoints,
auto-resume from the latest complete one, and data that is a pure function
of the step (see ``training/fault_tolerance.py``). ``main(argv)`` returns
the metrics history, ``train(argv)`` the final state beside it.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import DataConfig, batch_at
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.compression import CompressionConfig
from repro_torch.training.fault_tolerance import (FailureInjector,
                                                  StepWatchdog, run_training)
from repro_torch.training.train_loop import (TrainConfig, init_state,
                                             make_train_step)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="tensorized-sketch gradient compression (the paper)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (FT testing)")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def train(argv=None, *, wrap_step=None):
    """Parse ``argv`` and train: (final state, metrics history, a dict of
    floats a step). ``wrap_step(step_fn) -> step_fn``, if given, wraps the
    train step (a caller's timers)."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, "smoke" if args.smoke else "full")
    tc = TrainConfig(
        adamw=opt_lib.AdamWConfig(peak_lr=args.lr, warmup_steps=args.warmup,
                                  decay_steps=max(args.steps, 10)),
        grad_accum=args.grad_accum,
        compression=CompressionConfig(min_size=4096) if args.compress
        else None,
    )
    dc = DataConfig(batch_size=args.batch, seq_len=args.seq, seed=args.seed)
    mesh = make_local_mesh(device=dev)

    with axis_rules(mesh):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state, sketch = init_state(cfg, tc, gen, device=dev)
        step_fn = make_train_step(cfg, tc, sketch=sketch)
        if wrap_step is not None:
            step_fn = wrap_step(step_fn)
        watchdog = StepWatchdog()
        injector = FailureInjector(fail_at_step=args.fail_at)
        state, history = run_training(
            train_step=step_fn,
            init_state_fn=lambda: state,
            batch_fn=lambda step: batch_at(dc, cfg, step, device=dev),
            num_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            injector=injector,
            watchdog=watchdog)

    first = history[0]["loss"] if history else float("nan")
    last = history[-1]["loss"] if history else float("nan")
    print(f"[train] done: loss {first:.4f} -> {last:.4f} "
          f"({len(watchdog.straggler_steps)} straggler steps)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    return state, history


def main(argv=None):
    """Train; returns the metrics history."""
    return train(argv)[1]


if __name__ == "__main__":
    main()
