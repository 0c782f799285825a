"""Training launcher: the fault-tolerant loop of one architecture on one
card, fed by the bitmap-indexed data pipeline.

    python -m repro_torch.launch.train --demo [--device cpu]
    python -m repro_torch.launch.train --arch <arch> --steps 100 \\
        --global-batch 8 --seq 512

The one-card twin of ``repro.launch.train``: the same flags but the
cluster ones (``--coordinator``, ``--num-hosts``, ``--host-id``,
``--multi-pod`` drive ``jax.distributed`` and wait for a multi-card slice).
Weights are random (seed 0); the corpus is the pipeline's synthetic one,
selected by a bitmap query (domain 3).  Checkpoints go to ``--ckpt-dir``
(default under the system's temporary directory) and a rerun resumes from
the latest.  It runs on the card unless ``--device cpu`` is given;
``--demo`` takes the architecture's reduced smoke config.  The full
configs hold fp32 weights, gradients and AdamW moments (16 B a parameter),
so Qwen2-7B (~122 GB of state) and the larger ones need more than one
card: ``chip_smoke.py`` cuts Qwen2-7B to 8 layers for one H100.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--demo", action="store_true",
                    help="the architecture's reduced smoke config")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    from repro_torch.engine.planner import key
    from repro_torch.engine.policy import resolve_device
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import TrainConfig

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.demo else get_config(args.arch)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      docs_per_shard=max(args.global_batch * 8, 256),
                      num_shards=2, num_attributes=32)
    ds = BitmapIndexedDataset(dcfg, device=dev)

    def batches(start):
        return ds.batches(args.global_batch, where=key(3), seed=0,
                          start_step=start)

    tcfg = TrainConfig(OptimConfig(warmup_steps=max(args.steps // 10, 1),
                                   decay_steps=args.steps),
                       accum_steps=args.accum)
    out = train_loop(cfg, tcfg, LoopConfig(total_steps=args.steps,
                                           ckpt_dir=args.ckpt_dir),
                     batches, device=dev)
    print(f"{cfg.name} on {dev}: final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
