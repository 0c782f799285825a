"""Training launcher: the fault-tolerant loop of one architecture, fed by
the bitmap-indexed data pipeline, on one card or across processes.

    python -m repro_torch.launch.train --demo [--device cpu]
    python -m repro_torch.launch.train --arch <arch> --steps 100 \\
        --global-batch 8 --seq 512
    python -m repro_torch.launch.train --arch qwen2-7b \\
        --coordinator <host:port> --num-hosts 64 --host-id $SLURM_PROCID \\
        [--multi-pod]

The twin of ``repro.launch.train``.  Without ``--coordinator`` it trains in
this process on the card (``--device cpu``: the CPU), unsharded.  With it,
every host runs the command: ``torch.distributed`` starts at
``tcp://<coordinator>`` with one process per local card (this process, or
as many spawned as there are cards; ``--device cpu``: one ``gloo`` process
a host), ranks ``host_id * local + i`` of ``num_hosts * local``; under
``torchrun`` the processes come from its ``RANK``, ``LOCAL_RANK`` and
``WORLD_SIZE`` (and ``MASTER_ADDR``/``MASTER_PORT`` without
``--coordinator``) instead.  The mesh is the production one (16x16, or
2x16x16 with ``--multi-pod``: 256 or 512 processes) in cluster mode, and
the smoke mesh (data over every process) under ``--demo``; the parameters,
the AdamW state and each batch are sharded over it
(``repro_torch.train.loop``), rank 0 logs and writes the checkpoints, and
a restart on any mesh restores by name.  Weights are random (seed 0); the
corpus is the pipeline's synthetic one, selected by a bitmap query (domain
3).  Checkpoints go to ``--ckpt-dir`` (default under the system's
temporary directory), every ``--ckpt-every`` steps and at the end, and
a rerun resumes from the latest.  ``--demo``
takes the architecture's reduced smoke config.  The full configs hold fp32
weights, gradients and AdamW moments (16 B a parameter): Qwen2-7B (~122
GB of state) needs the state sharded over cards, or ``chip_smoke.py``'s cut
to 8 layers on one H100.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def _args(argv):
    from repro_torch.train.loop import LoopConfig
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=LoopConfig.ckpt_every,
                    help="steps between checkpoints (and one at the end)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (cluster mode)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--demo", action="store_true",
                    help="the architecture's reduced smoke config")
    return ap.parse_args(argv)


def _train(args, mesh=None) -> None:
    from repro_torch.checkpoint.store import writes
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig
    from repro_torch.engine.planner import key
    from repro_torch.engine.policy import resolve_device
    from repro_torch.optim.adamw import OptimConfig
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step import TrainConfig

    dev = mesh.device if mesh is not None else resolve_device(args.device)
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
                                           ckpt_dir=args.ckpt_dir,
                                           ckpt_every=args.ckpt_every),
                     batches, device=dev, mesh=mesh)
    if writes():
        where = dev if mesh is None else f"the {mesh.name} mesh of {dev.type}"
        print(f"{cfg.name} on {where}: final loss: {out['final_loss']}",
              flush=True)


def _worker(local_rank: int, argv, world: int, rank0: int,
            coordinator: str) -> None:
    """One process of the group: join it, build the mesh, train."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (init_distributed, make_device_mesh,
                                         make_production_mesh,
                                         make_smoke_mesh)
    args = _args(argv)
    dev = init_distributed(coordinator, world, rank0 + local_rank,
                           device=args.device, local_rank=local_rank)
    try:
        if args.demo:
            mesh = make_smoke_mesh(dev)
        else:
            prod = make_production_mesh(multi_pod=args.multi_pod)
            mesh = make_device_mesh(prod.axis_sizes, prod.axis_names, dev)
        _train(args, mesh)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    args = _args(argv)
    import torch

    from repro_torch.engine.policy import resolve_device
    dev = resolve_device(args.device)       # raises without a card
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:          # under torchrun
        coordinator = args.coordinator or (f"{env['MASTER_ADDR']}:"
                                           f"{env['MASTER_PORT']}")
        local = int(env.get("LOCAL_RANK", 0))
        _worker(local, argv, int(env["WORLD_SIZE"]),
                int(env["RANK"]) - local, coordinator)
        return
    if not args.coordinator:
        _train(args)
        return
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    world, rank0 = args.num_hosts * local, args.host_id * local
    if local == 1:
        _worker(0, argv, world, rank0, args.coordinator)
        return
    import torch.multiprocessing as mp
    mp.spawn(_worker, args=(argv, world, rank0, args.coordinator),
             nprocs=local)


if __name__ == "__main__":
    main()
