"""Training launcher: the port's ``Trainer`` (port of
``repro.launch.train``).

  python -m repro_torch.launch.train --arch smollm-135m          # on cuda
  python -m repro_torch.launch.train --arch smollm-135m --smoke --device cpu
  python -m repro_torch.launch.train --microbatches 2 --compress-grads \
      --checkpoint-dir ckpt/ --checkpoint-every 50    # resumes from ckpt/

Auto-resume from the newest checkpoint, async snapshots, a SIGTERM-safe
exit, the straggler monitor and a deterministic data resume, as the
reference's launcher.  On the CPU a config of more than 1e9 parameters
needs ``--smoke``.  The reference's TPU XLA flags have no counterpart.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.data import DataConfig
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_NAMES, default="smollm-135m")
    p.add_argument("--smoke", action="store_true",
                   help="use the reduced smoke config (CPU-trainable)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; cuda without a GPU fails")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    args = p.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    if device.type == "cpu" and not args.smoke and cfg.param_count > 1e9:
        raise SystemExit(
            f"{cfg.name} has {cfg.param_count/1e9:.0f}B params - on the CPU "
            "run with --smoke")

    trainer = Trainer(
        cfg,
        AdamWConfig(lr=args.lr, total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 1)),
        TrainConfig(steps=args.steps, microbatches=args.microbatches,
                    compress_grads=args.compress_grads,
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                   global_batch=args.global_batch),
        device=device)
    result = trainer.run()
    print(f"final loss: {result['history'][-1]['loss']:.4f}  "
          f"straggler events: {len(result['straggler_events'])}")
    return result


if __name__ == "__main__":
    main()
