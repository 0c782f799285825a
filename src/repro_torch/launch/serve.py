"""Serving launcher: batched prefill + greedy decode of one architecture on
one card.

    python -m repro_torch.launch.serve --arch qwen2-7b --batch 4 \\
        --prompt-len 2048 --steps 32
    python -m repro_torch.launch.serve --demo --device cpu

Weights are random (seed 0); prompts are random token ids from the same
seed.  It runs on the card unless ``--device cpu`` is given (with
``--demo``, the architecture's reduced smoke config, for a CPU run).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--demo", action="store_true",
                    help="the architecture's reduced smoke config")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.engine.policy import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.serve.step import greedy_generate

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.demo else get_config(args.arch)
    params = init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompts, steps=args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {dev}: {out.numel()} tokens in {dt:.2f}s "
          f"({out.numel() / dt:.1f} tok/s); first row {out[0].tolist()}")


if __name__ == "__main__":
    main()
