"""End-to-end driver: train a ~100M-parameter decoder LM on the synthetic
pipeline with the full production stack (AdamW, remat, checkpointing,
fault-tolerant loop), on the GPU.

Full run (a few hundred steps):
    python examples/port/train_lm.py --steps 300

CI-sized check on the CPU:
    python examples/port/train_lm.py --steps 5 --tiny --device cpu

The port's twin of ``examples/train_lm.py``: the same two configs, flags and
prints, through ``repro_torch.launch.train.Trainer`` (it imports neither
``jax`` nor ``repro``).  AdamW runs as the ``fused_adam`` kernel on the GPU.
As configured (``use_flash=False``, the reference's value) the model bypasses
the flash and rmsnorm kernels: attention and norms run as plain PyTorch on
the GPU too, whereas ``python -m repro_torch.launch.train`` always sets
``use_flash=True``.
The checkpoints and the JSONL log go under the temporary directory
(``$TMPDIR``, else ``/tmp``) by names of their own, so the twin never resumes
from the reference's checkpoints.
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402

LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=10, d_model=640, n_heads=10,
    n_kv_heads=5, head_dim=64, d_ff=2560, vocab=32768, mlp="swiglu",
    remat="dots_no_batch",
)

LM_TINY = ModelConfig(
    name="lm-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, head_dim=32, d_ff=512, vocab=1024, mlp="swiglu",
    remat="none",
)


def main(argv=None):
    """Returns the trainer's log: one dict a step this call ran."""
    tmp = tempfile.gettempdir()
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tmp, "lm100m_torch_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) | cpu")
    args = ap.parse_args(argv)

    cfg = LM_TINY if args.tiny else LM_100M
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params")
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    tr = Trainer(cfg, shape, lr=args.lr, ckpt_dir=args.ckpt_dir,
                 ckpt_every=50, device=args.device)
    logs = tr.fit(args.steps, log_path=os.path.join(tmp, "lm100m_torch_log.jsonl"))
    if tr.ckpt:
        tr.ckpt.close()
    for l in logs[:: max(len(logs) // 10, 1)]:
        print(f"  step {l['step']:4d}  loss {l['loss']:.4f}  "
              f"({l['time_s']:.2f}s)")
    print(f"final loss {logs[-1]['loss']:.4f} after {len(logs)} steps; "
          f"checkpoints in {args.ckpt_dir}")
    return logs


if __name__ == "__main__":
    main()
