"""End-to-end driver on the port: train a ~100M-parameter LM for a few
hundred steps on the bitmap-indexed data pipeline, with checkpoint/restart
fault tolerance.  The twin of ``examples/train_lm.py``; it imports neither
``jax`` nor ``repro``.

The data selection ("domain 3, high quality, not flagged") runs as bitmap
queries over BIC-built indexes — the paper's technique in the data plane —
on the card's bitmap kernels, and the model trains there through the flash
forward and backward kernels.

Run:  python examples/train_lm_torch.py [--steps 300] [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.data.pipeline import BitmapIndexedDataset, DataConfig  # noqa: E402
from repro_torch.engine.planner import key  # noqa: E402
from repro_torch.engine.policy import resolve_device  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.optim.adamw import OptimConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, train_loop  # noqa: E402
from repro_torch.train.step import TrainConfig  # noqa: E402

# ~100M params: 12L x 768d, GQA 12/4, 32k vocab (qwen2-family reduced)
CFG = ModelConfig(
    name="lm-100m", family="dense", source="examples",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
    d_ff=3072, vocab_size=32000, rope="rope", tie_embeddings=True,
)
#: domain == 3 AND quality == 18, NOT flag 25
SELECTION = key(3) & key(18) & ~key(25)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print(f"model: {CFG.param_count()/1e6:.0f}M params on {dev}")
    dcfg = DataConfig(vocab_size=CFG.vocab_size, seq_len=args.seq,
                      docs_per_shard=512, num_shards=4, num_attributes=32)
    ds = BitmapIndexedDataset(dcfg, device=dev)
    n_sel = sum(len(ds.select(s, where=SELECTION))
                for s in range(dcfg.num_shards))
    print(f"bitmap query selected {n_sel} / "
          f"{dcfg.num_shards * dcfg.docs_per_shard} documents")

    def batches(start_step: int):
        return ds.batches(args.batch, where=SELECTION, seed=0,
                          start_step=start_step)

    out = train_loop(
        CFG,
        TrainConfig(OptimConfig(peak_lr=3e-4, warmup_steps=20,
                                decay_steps=args.steps)),
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                   ckpt_every=100, log_every=10),
        batches, device=dev)
    print(f"done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
