"""Dry run: every (architecture x input-shape) cell's per-device memory and
flops, before anything is allocated on a card.

The port's twin of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's step against the production meshes (16x16, 2x16x16)
and reads XLA's memory and cost analysis.  The port compiles no HLO, so:

* the per-device argument bytes of every mesh are the sums of
  ``parallel.sharding.shard_bytes`` over the parameters, the optimizer
  state, the batch and the cache under the reference's specs (those are
  XLA's ``argument_size_in_bytes`` to the byte: it pads nothing);
* on the one-card mesh (``--card``: the H100 the port runs on) the step is
  traced as the port runs it (``make_train_step``, ``make_prefill_step``,
  ``make_decode_step``) on meta tensors, with no allocation and no card:
  :class:`LiveBytes` follows every storage from its making to its
  freeing, the checkpointed layers' recompute included, for the peak of
  live bytes beyond the arguments (``temp_size_in_bytes``);
  :class:`FlopCount` counts the products of every layer and every
  microbatch by ``torch.utils.flop_counter``'s formulas (the registry of
  ``FlopCounterMode``, whose module tracker would keep the activations
  alive), and the flash wrappers' meta route the attention kernels' calls
  and flops (``kernels.attention``).  The trace
  runs each layer, so nothing is counted once for many: the reference's
  ``l0`` compile and ``benchmarks/roofline.py``'s loop corrections exist
  because XLA counts a scan body once, and have no counterpart here.
  A train step with n > 2 accumulation microbatches is traced as the
  port's step of two microbatches over the first 2 / n of the batch's
  rows, a view (every microbatch has the whole step's shape: the second
  shows the steady state's memory, where the gradients already exist and
  each new one is added to them), and the counts of the two are scaled
  by n / 2;
* on a multi-device mesh the port shards no activations and traces no
  step: ``temp`` and ``flops`` are None, with the reason.  Nor is there a
  collective to count on one card (the reference parses its HLO's
  collectives; the port has none): ``collective_bytes`` is None.

Usage:
  python -m repro_torch.launch.dryrun --card --arch qwen2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, canonical, get_config
from repro_torch.kernels import attention
from repro_torch.launch.mesh import (AbstractMesh, make_production_mesh,
                                     set_mesh)
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, batch_specs,
                                       skip_reason)
from repro_torch.models.model import (Model, _empty_caches, _schema,
                                      _store_dtype, cache_logical,
                                      param_logical, unstack_layers)
from repro_torch.optim.adamw import OptimConfig, abstract_opt_state
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import logical_spec, shard_bytes
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.step import TrainConfig, make_train_step

ACCUM_STEPS = int(os.environ.get("DRYRUN_ACCUM", "4"))
# Wider models need more microbatching to keep the per-device activation
# working set small; capped so the per-device microbatch stays >= 1.
ACCUM_BY_ARCH = {"command_r_plus_104b": 16, "granite_20b": 8}
#: microbatches of an accumulating train step that the trace runs
TRACED_MICROBATCHES = 2
#: the estimate's bound: a predicted peak (arguments + temp) against the
#: card's ``max_memory_allocated``, as a fraction of the prediction
#: (PERF.md states it beside the dry run's predictions)
PEAK_BOUND = 0.2
#: a cell fits the H100 when its predicted peak, PEAK_BOUND over, stays
#: within the card's nominal 80 GB; the CUDA context lives in the card's
#: memory past 80e9 B
CARD_BYTES = 80 * 10 ** 9
#: the CUDA caching allocator's rounding of every block
ALLOC_ROUND = 512


def card_mesh() -> AbstractMesh:
    """The one-card mesh: (1,) over ``data``."""
    return AbstractMesh((1,), ("data",))


def mesh_label(mesh: AbstractMesh) -> str:
    return "card" if mesh.size == 1 else mesh.name


# ------------------------------------------------------------------ tracing
class LiveBytes(TorchDispatchMode):
    """Live storage bytes while ops run: every storage an op returns that
    is neither known beforehand (``known``: the arguments) nor already
    counted is added once, rounded up to the caching allocator's 512
    bytes, and taken off when it is freed (a finalizer on the storage).
    ``peak``, the largest total seen after any op, is the step's temp
    (the arguments are not in it).  Views share their base's storage, so
    they add nothing; ``torch.utils.checkpoint``'s recompute runs ops like
    any other, so its activations are counted where they live."""

    def __init__(self, known=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._counted: set[int] = set()
        self._known = {t.untyped_storage()._cdata for t in tree_leaves(known)
                       if isinstance(t, torch.Tensor)}

    def _free(self, key: int, nbytes: int) -> None:
        self._counted.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._counted or key in self._known:
                continue
            nbytes = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
            self._counted.add(key)
            self.live += nbytes
            weakref.finalize(st, self._free, key, nbytes)
        self.peak = max(self.peak, self.live)
        return out


class FlopCount(TorchDispatchMode):
    """The products' flops by the per-op formulas that
    ``torch.utils.flop_counter.FlopCounterMode`` counts with (its
    ``flop_registry``), without that mode's module tracker: the tracker's
    backward hooks keep every module's output alive, which no real step
    can afford (Whisper-small's train_4k step peaks at 25 GB; traced under
    ``FlopCounterMode`` it reads 159 GB, and run under it on the card it
    runs out of memory)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        return out


def trace(fn, args: tuple) -> dict:
    """Run ``fn(*args)`` on meta tensors under :class:`LiveBytes` and
    :class:`FlopCount`.  Returns the products' flops, the flash kernels'
    calls and flops (their meta route), the peak of live bytes beyond the
    arguments, and the bytes of the outputs."""
    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd
    for fn_ in (fwd, bwd):
        fn_.traced = fn_.traced_flops = 0
    counter, live = FlopCount(), LiveBytes(known=args)
    t0 = time.perf_counter()
    with counter, live:
        out = fn(*args)
    if isinstance(out, tuple) and out and isinstance(out[0], Model):
        out = (dict(out[0].named_parameters()), *out[1:])
    return {"trace_s": time.perf_counter() - t0,
            "matmul_flops": counter.flops,
            "flash_calls": {"flash_attention_fwd": fwd.traced,
                            "flash_attention_bwd": bwd.traced},
            "flash_flops": fwd.traced_flops + bwd.traced_flops,
            "temp": live.peak, "output": tree_bytes(out)}


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree`` (whole, on one device)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ------------------------------------------------------------- the cells
def meta_params(cfg, dtype: torch.dtype = torch.float32, *,
                port_storage: bool = False) -> dict[str, torch.Tensor]:
    """The flat parameter dict (the reference's names, per-layer tensors
    stacked on L) as meta tensors in ``dtype``: every leaf, as the
    reference's ``abstract_params`` (fp32) and its ``serve_tp`` cast
    (bf16) have it; with ``port_storage``, norm scales and the SSM's small
    parameters in fp32 whatever ``dtype``, as ``init_params`` stores
    them."""
    return {name: torch.empty(shape, device="meta",
                              dtype=(_store_dtype(name, dtype)
                                     if port_storage else dtype))
            for name, (shape, _) in _schema(cfg).items()}


def accum_steps(cfg, shape, mesh: AbstractMesh, variant: str = "") -> int:
    """The reference's accumulation: ``ACCUM_BY_ARCH`` or ``ACCUM_STEPS``,
    ``accumN`` in the variant, capped so that each data-parallel device's
    microbatch holds at least one row."""
    dp_size = 1
    for ax in ("pod", "data"):
        dp_size *= mesh.shape.get(ax, 1)
    accum = ACCUM_BY_ARCH.get(cfg.name.replace("-", "_").replace(".", "_"),
                              ACCUM_STEPS)
    m = re.search(r"accum(\d+)", variant)
    if m:
        accum = int(m.group(1))
    return max(1, min(accum, shape.global_batch // dp_size))


def leading_rows(batch: dict, runs: int, accum: int) -> dict:
    """The first ``runs`` / ``accum`` of the batch's rows (axis 1 of
    ``mrope_positions``, as ``train.step.microbatch`` has it), as views;
    a tensor of fewer than two axes whole."""
    def take(k, x):
        ax = 1 if k == "mrope_positions" else 0
        if x.dim() < 2:
            return x
        if x.shape[ax] % accum:
            raise ValueError(f"{k}: {x.shape[ax]} rows do not divide into "
                             f"{accum} microbatches")
        return x.narrow(ax, 0, x.shape[ax] // accum * runs)
    return {k: take(k, x) for k, x in batch.items()}


def train_fn(cfg, accum: int, runs: int | None = None):
    """The port's train step over the flat arguments (params, opt, batch)
    of a dry-run cell: the :class:`Model` holds per-layer views of the
    stacked parameters, and the optimizer state views of the stacked
    moments, so nothing is copied.  With ``runs`` r < ``accum`` n (the
    trace's cut) it is the port's step of r microbatches over the batch's
    first r / n of its rows, a view: ``train.step.microbatch`` cuts
    strided rows, so each microbatch has the whole step's shape, and only
    the gradients' and the loss's divisor (r for n) differs."""
    runs = accum if runs is None else runs
    step = make_train_step(cfg, TrainConfig(OptimConfig(), accum_steps=runs))

    def fn(params, opt, batch):
        if runs < accum:
            batch = leading_rows(batch, runs, accum)
        named = {"m": unstack_layers(cfg, opt["m"]),
                 "v": unstack_layers(cfg, opt["v"]), "step": opt["step"]}
        return step(Model(cfg, params), named, batch)
    return fn


def prefill_fn(cfg, max_len: int):
    step = make_prefill_step(cfg, max_len=max_len)
    return lambda params, batch: step(Model(cfg, params), batch)


def decode_fn(cfg, pos: int):
    """The port's decode step at position ``pos``: the port reads ``pos``
    on the host, so the traced step is given it (the last position, where
    the step reads the whole cache) in place of the cache's scalar."""
    step = make_decode_step(cfg)

    def fn(params, batch):
        cache = dict(batch["cache"], pos=pos)
        return step(Model(cfg, params), {"tokens": batch["tokens"],
                                         "cache": cache})
    return fn


def build_step_and_specs(cfg, shape, mesh: AbstractMesh, variant: str = ""):
    """Returns (step_fn, args (meta tensors, the reference's structure),
    specs (the same structure), donated argument indices, accumulation).
    Sets the thread's sharding rules as the reference does (``serve_tp``
    and ``no_fsdp`` map ``fsdp`` to None; ``serve_tp`` serves bf16
    parameters); call it with ``mesh`` current."""
    serve_tp = "serve_tp" in variant and shape.kind != "train"
    # TP-only weights: no gathers over data
    sharding.set_rules(serve_tp_rules() if serve_tp or "no_fsdp" in variant
                       else dict(sharding.DEFAULT_RULES))
    params = meta_params(cfg, torch.bfloat16 if serve_tp else torch.float32)
    p_logical = param_logical(cfg)
    p_spec = {k: logical_spec(params[k].shape, p_logical[k]) for k in params}
    batch = batch_specs(cfg, shape)

    def batch_spec(name, x):
        if name == "mrope_positions":
            return logical_spec(x.shape, (None, "batch", None))
        if name == "pos" or not x.dim():
            return ()
        return logical_spec(x.shape, ("batch",) + (None,) * (x.dim() - 1))

    if shape.kind == "train":
        accum = accum_steps(cfg, shape, mesh, variant)
        opt = abstract_opt_state(params, OptimConfig())
        o_spec = {"m": p_spec, "v": p_spec, "step": ()}
        b_spec = {k: batch_spec(k, v) for k, v in batch.items()}
        step = train_fn(cfg, accum, min(accum, TRACED_MICROBATCHES))
        return step, (params, opt, batch), (p_spec, o_spec, b_spec), (0, 1), \
            accum

    if shape.kind == "prefill":
        b_spec = {k: batch_spec(k, v) for k, v in batch.items()}
        return (prefill_fn(cfg, shape.seq_len), (params, batch),
                (p_spec, b_spec), (), 1)

    # decode: the cache is donated (updated in place by the port)
    c_logical = cache_logical(cfg)
    c_spec = {k: logical_spec(v.shape, c_logical[k]) if k != "pos" else ()
              for k, v in batch["cache"].items()}
    b_spec = {"tokens": batch_spec("tokens", batch["tokens"]),
              "cache": c_spec}
    return (decode_fn(cfg, shape.seq_len - 1), (params, batch),
            (p_spec, b_spec), (1,), 1)


def tree_shard_bytes(tree, specs, mesh: AbstractMesh) -> int:
    """Per-device bytes of a tree of meta tensors under its specs."""
    if isinstance(tree, torch.Tensor):
        return shard_bytes(tree, specs, mesh)
    if isinstance(tree, dict):
        return sum(tree_shard_bytes(v, specs[k], mesh)
                   for k, v in tree.items())
    return sum(tree_shard_bytes(v, s, mesh) for v, s in zip(tree, specs))


def serve_tp_rules() -> dict:
    """The ``serve_tp`` variant's rules (the default rules with ``fsdp``
    mapped to None: TP-only weights), as :func:`build_step_and_specs` sets
    them for a serving cell."""
    return dict(sharding.DEFAULT_RULES, fsdp=None)


def serve_arg_bytes(cfg, mesh: AbstractMesh, batch: int, max_len: int,
                    dtype: torch.dtype = torch.bfloat16) -> dict:
    """Per-device bytes on ``mesh`` under the ``serve_tp`` rules of what
    ``init_params(cfg, dtype=dtype, mesh=)`` and ``init_cache(cfg, batch,
    max_len, mesh=)`` place on one device: each parameter in the port's
    storage (``meta_params(..., port_storage=True)``) and each cache entry
    (the compute dtype) by ``shard_bytes`` of its ``logical_spec``.  Sets
    the calling thread's rules to :func:`serve_tp_rules`."""
    sharding.set_rules(serve_tp_rules())
    params = meta_params(cfg, dtype, port_storage=True)
    caches = _empty_caches(cfg, batch, max_len, torch.device("meta"))
    p_logical, c_logical = param_logical(cfg), cache_logical(cfg)
    with set_mesh(mesh):
        return {
            "params": sum(shard_bytes(t, logical_spec(t.shape, p_logical[k]),
                                      mesh) for k, t in params.items()),
            "cache": sum(shard_bytes(t, logical_spec(t.shape, c_logical[k]),
                                     mesh) for k, t in caches.items())}


def model_flops(cfg, shape) -> float:
    """The assignment's definition (``benchmarks/roofline.py``'s): 6 N T in
    train (N the active parameters for an MoE), 2 N T serving."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # one token per sequence


def _analyze(cfg, shape, mesh: AbstractMesh, variant: str) -> dict:
    fn, args, specs, donate, accum = build_step_and_specs(cfg, shape, mesh,
                                                          variant)
    arg_bytes = tree_shard_bytes(args, specs, mesh)
    if shape.kind == "decode":
        alias = tree_shard_bytes(args[1]["cache"], specs[1]["cache"], mesh)
    else:
        alias = sum(tree_shard_bytes(args[i], specs[i], mesh)
                    for i in donate)
    out = {"accum_steps": accum,
           "memory": {"argument_size_in_bytes": arg_bytes,
                      "alias_size_in_bytes": alias,
                      "output_size_in_bytes": None,
                      "temp_size_in_bytes": None},
           "flops": None, "model_flops": model_flops(cfg, shape),
           "collective_bytes": None,
           "collective_reason": "the port compiles no HLO, and one card has "
                                "no collectives"}
    if mesh.size != 1:
        out["temp_reason"] = out["flops_reason"] = (
            "the port shards no activations and traces no step on a "
            "multi-device mesh")
        return out
    t = trace(fn, args)
    runs = min(accum, TRACED_MICROBATCHES)
    out["memory"]["temp_size_in_bytes"] = t["temp"]
    out["memory"]["output_size_in_bytes"] = t["output"]
    out["trace_s"] = t["trace_s"]
    out["traced_microbatches"] = runs
    # every microbatch alike: the counts of ``runs`` of them, times n/runs
    out["matmul_flops"] = t["matmul_flops"] * accum // runs
    out["flash_flops"] = t["flash_flops"] * accum // runs
    out["flops"] = out["matmul_flops"] + out["flash_flops"]
    out["flash_calls"] = {k: v * accum // runs
                          for k, v in t["flash_calls"].items()}
    out["peak_bytes"] = arg_bytes + t["temp"]
    out["fits_card"] = out["peak_bytes"] * (1 + PEAK_BOUND) <= CARD_BYTES
    return out


def config_peak(cfg, kind: str, batch: int, seq: int, *,
                max_len: int | None = None,
                param_dtype: torch.dtype = torch.float32,
                token_dtype: torch.dtype = torch.int32) -> dict:
    """One step at any configuration on one card, traced as the caller
    runs it: a train step (no accumulation) over fp32 masters and AdamW
    moments (``param_dtype`` fp32), a prefill of ``seq`` tokens into a
    cache of ``max_len`` positions, or a decode at position ``seq`` - 1;
    parameters stored as ``init_params(..., dtype=param_dtype)`` stores
    them (norm scales and the SSM's small parameters in fp32), token ids
    in ``token_dtype``.  Returns :func:`trace`'s figures and the arguments'
    bytes."""
    b = batch_specs(cfg, ShapeSpec(kind, seq, batch, kind))
    for k in ("tokens", "labels"):
        if k in b:
            b[k] = torch.empty(b[k].shape, dtype=token_dtype, device="meta")
    params = meta_params(cfg, param_dtype, port_storage=True)
    if kind == "train":
        args = (params, abstract_opt_state(params, OptimConfig()), b)
        fn = train_fn(cfg, 1)
    elif kind == "prefill":
        args, fn = (params, b), prefill_fn(cfg, max_len or seq)
    else:
        args, fn = (params, b), decode_fn(cfg, seq - 1)
    return {"argument_bytes": tree_bytes(args), **trace(fn, args)}


# Hillclimb variants: applied as config overrides on top of the arch.
def _moe_ep(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            ep_pad=True))


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


VARIANTS = {
    "block_skip": lambda cfg: _replace(cfg, flash_block_skip=True),
    "remat_dots": lambda cfg: _replace(cfg, remat="dots"),
    "no_remat": lambda cfg: _replace(cfg, remat="none"),
    "seq_sp": lambda cfg: _replace(cfg, seq_sharded=True),
    "ulysses": lambda cfg: _replace(cfg, ulysses_attn=True),
    "moe_ep": _moe_ep,
    # accumN: accumulation-step override, handled in build_step_and_specs
    "accum1": lambda cfg: cfg,
    "accum2": lambda cfg: cfg,
    "accum4": lambda cfg: cfg,
    "accum8": lambda cfg: cfg,
    # serve_tp: serving cells drop FSDP (weights TP-only, bf16);
    # handled in build_step_and_specs
    "serve_tp": lambda cfg: cfg,
    "no_fsdp": lambda cfg: cfg,
}


def run_cell(arch: str, shape_name: str, mesh: AbstractMesh,
             variant: str = "") -> dict:
    """One (arch, shape, mesh) cell: its status or skip reason, per-device
    argument bytes and, on the one-card mesh, the traced step's temp,
    output bytes, flops and ``fits_card``.  The thread's sharding rules are
    restored afterwards."""
    cfg = get_config(arch)
    for v in filter(None, variant.split(",")):
        cfg = VARIANTS[v](cfg)
    shape = SHAPES[shape_name]
    cell = {"arch": arch, "shape": shape_name, "mesh": mesh_label(mesh),
            "variant": variant}
    reason = skip_reason(cfg, shape)
    if reason:
        cell["status"] = "skipped"
        cell["reason"] = reason
        return cell
    rules = sharding.get_rules()
    try:
        with set_mesh(mesh):
            cell.update(_analyze(cfg, shape, mesh, variant))
    finally:
        sharding.set_rules(rules)
    cell["status"] = "ok"
    cell["num_devices"] = mesh.size
    return cell


def run_cell_or_error(arch: str, shape_name: str, mesh: AbstractMesh,
                      variant: str = "") -> dict:
    """:func:`run_cell`, an exception recorded in the cell (status
    ``error``) rather than raised."""
    try:
        return run_cell(arch, shape_name, mesh, variant)
    except Exception as e:  # noqa: BLE001  (recorded in the cell)
        return {"arch": arch, "shape": shape_name, "mesh": mesh_label(mesh),
                "variant": variant, "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--card", action="store_true",
                    help="the one-H100 mesh: trace each step on the meta "
                         "device (needs no card)")
    ap.add_argument("--variant", default="",
                    help="comma-separated config overrides (see VARIANTS)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args()

    archs = ARCHS if args.arch == "all" else [canonical(args.arch)]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.card:
        meshes = [card_mesh()]
    elif args.both_meshes:
        meshes = [make_production_mesh(), make_production_mesh(multi_pod=True)]
    else:
        meshes = [make_production_mesh(multi_pod=args.multi_pod)]
    tags = {"card": "card", "16x16": "sp", "2x16x16": "mp"}

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh in meshes:
                tag = f"{arch}-{shape_name}-{tags[mesh_label(mesh)]}"
                if args.variant:
                    tag += "-" + args.variant.replace(",", "+")
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[dryrun] {tag}: cached", flush=True)
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                cell = run_cell_or_error(arch, shape_name, mesh,
                                         args.variant)
                failures += cell["status"] == "error"
                with open(path, "w") as f:
                    json.dump(cell, f, indent=2)
                mem = cell.get("memory") or {}
                print(f"[dryrun] {tag}: {cell['status']} "
                      f"args={mem.get('argument_size_in_bytes', '-')} "
                      f"temp={mem.get('temp_size_in_bytes', '-')} "
                      f"flops={cell.get('flops', '-')} "
                      f"fits_card={cell.get('fits_card', '-')}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
