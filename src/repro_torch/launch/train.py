"""Fault-tolerant training loop (single device).

Responsibilities beyond the step:
  * checkpoint/restart (async writer, atomic commits, exact data resume);
  * failure handling — a step that raises ``NodeFailure`` restores the latest
    checkpoint and replays from there.  Only ``NodeFailure`` is treated that
    way: any other exception (a kernel that does not build or launch, a shape
    error, out of memory) propagates, because restoring and retrying would
    hide it and loop for ever;
  * straggler watchdog — steps exceeding ``straggler_factor ×`` the rolling
    median are logged and counted;
  * metrics logging (JSONL).

Runs on the GPU unless ``device="cpu"`` / ``--device cpu`` is given:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
      --steps 20 --batch 4 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --steps 20 --batch 4 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b --smoke \
      --device cpu --steps 20 --ckpt-dir ckpt_smoke
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import replace

import torch

from .. import resolve_device
from ..ckpt.store import AsyncCheckpointer, latest_step, load_checkpoint
from ..configs import get_config, get_shape, smoke_config
from ..data.pipeline import SyntheticDataset
from ..models.transformer import init_params
from ..optim.optimizers import make_optimizer, warmup_cosine
from ..training.train_step import make_train_step


class NodeFailure(RuntimeError):
    """A node dropped out mid-step: the one failure the trainer recovers from
    by restoring the latest checkpoint."""


class Trainer:
    def __init__(self, cfg, shape, optimizer: str = "adamw",
                 lr: float = 3e-4, grad_accum: int = 1,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 seed: int = 0, straggler_factor: float = 3.0,
                 device="cuda"):
        self.cfg, self.shape = cfg, shape
        self.device = resolve_device(device)
        self.opt = make_optimizer(optimizer, warmup_cosine(lr),
                                  state_dtype=cfg.state_dtype) \
            if optimizer == "adamw" else make_optimizer(optimizer, lr)
        self.grad_accum = grad_accum
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.straggler_factor = straggler_factor
        self.step_times: list[float] = []
        self.stragglers = 0
        self.failures = 0
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.step_fn = make_train_step(cfg, self.opt, grad_accum=grad_accum)

    def init_state(self):
        params = init_params(self.cfg, self.seed, self.device)
        return params, self.opt.init(params)

    # -- restore -------------------------------------------------------------

    def restore_or_init(self):
        params, opt_state = self.init_state()
        start = 0
        if self.ckpt_dir and latest_step(self.ckpt_dir) is not None:
            tmpl = {"params": params, "opt": opt_state}
            tree, manifest = load_checkpoint(self.ckpt_dir, tmpl,
                                             device=self.device)
            params, opt_state = tree["params"], tree["opt"]
            start = manifest["step"]
        return params, opt_state, start

    # -- the loop ------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, steps: int, batch_override: int | None = None,
            seq_override: int | None = None, log_path: str | None = None,
            inject_failure_at: int | None = None) -> list[dict]:
        params, opt_state, start = self.restore_or_init()
        data_kw = dict(batch_override=batch_override, seq_override=seq_override,
                       device=self.device)
        data = SyntheticDataset(self.cfg, self.shape, seed=self.seed,
                                start_step=start, **data_kw)
        logs: list[dict] = []
        log_f = open(log_path, "a") if log_path else None
        step = start
        while step < steps:
            batch = next(data)
            self._sync()
            t0 = time.time()
            try:
                if inject_failure_at is not None and step == inject_failure_at:
                    inject_failure_at = None
                    raise NodeFailure("injected node failure")
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch, step)
                metrics = {k: float(v) for k, v in metrics.items()}
                self._sync()
            except NodeFailure:
                self.failures += 1
                if self.ckpt is None:
                    raise
                # drop the broken state and restore the last commit
                self.ckpt.wait()
                del params, opt_state
                params, opt_state, start_r = self.restore_or_init()
                data = SyntheticDataset.from_state(
                    self.cfg, self.shape, {"step": start_r, "seed": self.seed},
                    **data_kw)
                step = start_r
                continue
            dt = time.time() - t0
            self.step_times.append(dt)
            med = statistics.median(self.step_times[-20:])
            if len(self.step_times) > 5 and dt > self.straggler_factor * med:
                self.stragglers += 1
                metrics["straggler"] = dt / med
            metrics.update(step=step, time_s=dt)
            logs.append(metrics)
            if log_f:
                log_f.write(json.dumps(metrics) + "\n")
                log_f.flush()
            step += 1
            if self.ckpt and (step % self.ckpt_every == 0 or step == steps):
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               extra={"arch": self.cfg.name})
        if self.ckpt:
            self.ckpt.wait()
        if log_f:
            log_f.close()
        self._last_state = (params, opt_state)
        return logs


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--log", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) | cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # the port's CLI trains through the hand-written kernels: flash attention
    # (the model keeps the gate S % 128 == 0 and takes the chunked / dense
    # branch otherwise), rmsnorm and ssd_chunk; AdamW always takes fused_adam
    cfg = replace(cfg, use_flash=True)
    shape = get_shape(args.shape)

    tr = Trainer(cfg, shape, optimizer=args.optimizer, lr=args.lr,
                 grad_accum=args.grad_accum, ckpt_dir=args.ckpt_dir or None,
                 device=args.device)
    logs = tr.fit(args.steps, batch_override=args.batch or None,
                  seq_override=args.seq or None, log_path=args.log or None)
    if tr.ckpt:
        tr.ckpt.close()
    first, last = logs[0], logs[-1]
    print(f"steps={len(logs)} loss {first['loss']:.4f} -> {last['loss']:.4f} "
          f"stragglers={tr.stragglers} failures={tr.failures}")


if __name__ == "__main__":
    main()
