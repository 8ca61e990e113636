"""Restartable trainer — the port of ``repro/launch/train.py``.

 - deterministic data pipeline (restart-safe: a batch is a function of
   (seed, step))
 - periodic async checkpointing with atomic commit + GC
 - --restart resumes from the latest committed checkpoint
 - failure-injection drill (--fail-at N) for the fault-tolerance test
 - straggler detector fed with per-step wall times

Usage (``--device cuda``, the default, runs the kernels on the card):
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --steps 50 --batch 8 --seq 128 --reduced --device cpu \\
        --ckpt-dir /tmp/ckpt

The weights are the port's own seeded draw (``model.init``); the trainer
keeps no ``embed_f32`` copy (``model.loss_fn`` upcasts ``embed`` in the
graph).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.pipeline import DataConfig, make_batch, to_device
from repro_torch.launch.steps import TrainConfig, make_train_step
from repro_torch.models import model
from repro_torch.optim import optimizers as opt
from repro_torch.runtime.fault_tolerance import (FailureInjector,
                                                 HeartbeatRegistry,
                                                 StragglerDetector)


def model_config(args):
    """The arch of ``args``, ``--reduced`` and cut to ``--layers``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def build_state(cfg, tcfg, *, seed: int, device):
    """(params, opt_state): ``model.init``'s weights without the serving
    copy ``embed_f32``, and the optimizer's initial state.  Under a mesh
    (``launch.mesh.use_mesh``) both are this rank's pieces, placed by
    ``param_specs(profile="train")`` and ``opt_state_specs`` as they are
    made (no whole tree on the device)."""
    params = model.init(cfg, seed=seed, device=device, profile="train")
    del params["embed_f32"]
    if hasattr(params, "specs"):
        del params.specs["embed_f32"]
    return params, opt.opt_init(tcfg.optimizer, params)


def run(args) -> dict:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--restart``).  Returns {"losses" (this run's,
    one a step), "final_step", "start_step", "stragglers", "alive"}."""
    if args.layers < 0:
        raise ValueError(f"--layers {args.layers}: give a positive count "
                         "or 0 for all")
    cfg = model_config(args)
    device = torch.device(args.device)
    data = DataConfig(seed=args.seed, global_batch=args.batch,
                      seq_len=args.seq)
    tcfg = TrainConfig(
        optimizer=opt.OptimizerConfig(lr=args.lr, warmup_steps=5,
                                      total_steps=args.steps),
        n_micro=args.n_micro)
    train_step = make_train_step(cfg, tcfg)

    start_step = 0
    params, opt_state = build_state(cfg, tcfg, seed=args.seed,
                                    device=device)
    if args.restart and args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            (params, opt_state), start_step = ckpt.restore(
                args.ckpt_dir, latest, (params, opt_state))
            print(f"[train] restored checkpoint step {start_step}")

    injector = FailureInjector(
        fail_at_steps=(args.fail_at,) if args.fail_at else ())
    heart = HeartbeatRegistry(timeout_s=60)
    strag = StragglerDetector()

    losses = []
    pending_save = None
    try:
        for step in range(start_step, args.steps):
            injector.check(step)
            heart.beat("host0")
            batch = to_device(cfg, make_batch(cfg, data, step), device)
            t0 = time.perf_counter()
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch, step)
            loss = float(metrics["nll"])         # waits for the step
            dt = time.perf_counter() - t0
            strag.record("host0", dt)
            losses.append(loss)
            if args.log_every and step % args.log_every == 0:
                print(f"[train] step {step} nll={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                if pending_save is not None:
                    pending_save.join()
                pending_save = ckpt.save(args.ckpt_dir, step + 1,
                                         (params, opt_state), blocking=False)
                ckpt.gc_old(args.ckpt_dir, keep=3)
    finally:
        if pending_save is not None:
            pending_save.join()
    return {"losses": losses, "final_step": args.steps,
            "start_step": start_step, "stragglers": strag.stragglers(),
            "alive": heart.alive()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch for CPU execution")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (the CPU runs the "
                         "kernels' plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (0 = all); "
                         "DeepSeek-R1's first 3 are its dense layers, the "
                         "rest MoE")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--restart", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a worker failure at this step (drill)")
    ap.add_argument("--log-every", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    out = run(parse_args())
    print(f"[train] done: final nll={out['losses'][-1]:.4f}")
