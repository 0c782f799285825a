"""The port's side of ``tests/test_torch_mesh_train.py``: processes of one
``gloo`` group on the CPU, each running the same program on its shard.

Imports ``torch`` and ``repro_torch`` only (a spawned process imports this
module to find its function).  :func:`spawn` starts ``world`` processes that
join a group through a file under a temporary directory (no TCP port, so
test files may run side by side) and run ``fn(rank, *args)``;
:func:`port_runs` is the program the test holds against the reference.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: the meshes of the test, (data, model)
MESHES = ((2, 2), (1, 4))
#: the mesh a checkpoint written on (2, 2) restores on
ELASTIC = (4, 1)
#: the configurations that raise on a device mesh (the families, and the
#: two attention options the slice does not cover)
UNCOVERED = ("qwen2_moe_a2_7b", "mamba2_2_7b", "hymba_1_5b",
             "whisper_small", "ulysses_attn", "seq_sharded")
LOSS_CHUNK = 16


def tag(shape) -> str:
    return "x".join(map(str, shape))


def _entry(rank: int, fn, world: int, init: str, args: tuple) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args) -> None:
    """``fn(rank, *args)`` in ``world`` processes of one ``gloo`` group."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_entry, args=(fn, world, os.path.join(tmp, "init"), args),
                 nprocs=world)


def _placements(t) -> str:
    return repr(tuple(t.placements))


def _full_stacked(cfg, named: dict) -> dict:
    from repro_torch.models.model import full_tensor, stack_layers
    return {k: (np.stack([full_tensor(x).numpy() for x in v])
                if isinstance(v, list) else full_tensor(v).numpy())
            for k, v in stack_layers(cfg, named, list).items()}


def _record_constraints(calls: list):
    """Wrap the model's ``constrain`` (as ``models.model`` and
    ``models.layers`` hold it) to record each call's logical names, shape
    and the placements it gave; returns the undo."""
    from repro_torch.models import layers, model
    from repro_torch.parallel import sharding

    def rec(x, logical):
        y = sharding.constrain(x, logical)
        calls.append((tuple(logical), tuple(x.shape), _placements(y)))
        return y
    model.constrain = layers.constrain = rec

    def undo():
        model.constrain = layers.constrain = sharding.constrain
    return undo


def port_runs(rank: int, src: str, dst: str, ckpt: str) -> None:
    """On each mesh of :data:`MESHES`: one train step of the Qwen2-7B smoke
    config at fp32 from ``src``'s parameters and batch, the fused loss's
    two cases, the parameters' and constraints' placements; a checkpoint
    of the (2, 2) state under ``ckpt`` restored on :data:`ELASTIC`; the
    uncovered configurations' errors.  Rank 0 writes ``dst`` (npz)."""
    import dataclasses

    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import loss as tloss
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import distribute
    from repro_torch.train import loop as tloop
    from repro_torch.train import step as tstep
    tmodel.COMPUTE_DTYPE = torch.float32
    data = dict(np.load(src))
    cfg = get_smoke_config("qwen2_7b")
    flat = {k[2:]: v for k, v in data.items() if k.startswith("p/")}
    batch = {k: torch.from_numpy(data[k]) for k in ("tokens", "labels")}
    ocfg = OptimConfig(warmup_steps=1, decay_steps=10)
    out = {}
    for shape in MESHES:
        t = tag(shape)
        mesh = make_device_mesh(shape, ("data", "model"), "cpu")
        params = tmodel.params_from_numpy(cfg, flat, mesh=mesh,
                                          dtype=torch.float32)
        for name, p in params.named_parameters():
            out[f"{t}/placement/{name}"] = np.array(_placements(p))
        opt = init_opt_state(params, ocfg)
        for name, m_ in opt["m"].items():
            out[f"{t}/moment_placement/{name}"] = np.array(_placements(m_))
        calls = []
        undo = _record_constraints(calls)
        try:
            step = tstep.make_train_step(cfg, tstep.TrainConfig(ocfg))
            params, opt, metrics = step(params, opt,
                                        tloop.distribute_batch(batch, mesh))
        finally:
            undo()
        out[f"{t}/constraints"] = np.array(sorted({repr(c) for c in calls}))
        out[f"{t}/loss"] = metrics["loss"].numpy()
        out[f"{t}/grad_norm"] = metrics["grad_norm"].numpy()
        named = {n: p.detach() for n, p in params.named_parameters()}
        for what, tree in (("p", named), ("m", opt["m"]), ("v", opt["v"])):
            for k, v in _full_stacked(cfg, tree).items():
                out[f"{t}/{what}/{k}"] = v
        if shape == (2, 2):
            ckpt_store.save_checkpoint(ckpt, 1,
                                       tloop.checkpoint_state(params, opt))
        for case in ("even", "odd"):
            x = distribute(torch.from_numpy(data[f"loss_{case}/x"]),
                           ("batch", None, "embed"), mesh).requires_grad_()
            head = distribute(torch.from_numpy(data[f"loss_{case}/head"]),
                              ("fsdp", "vocab"), mesh).requires_grad_()
            lab = distribute(torch.from_numpy(data[f"loss_{case}/labels"]),
                             ("batch", None), mesh)
            loss, _ = tloss.fused_ce_loss(x, head, lab, chunk=LOSS_CHUNK,
                                          valid_vocab=int(data["valid_vocab"]))
            loss.backward()
            out[f"{t}/loss_{case}/loss"] = loss.full_tensor().detach().numpy()
            out[f"{t}/loss_{case}/dx"] = x.grad.full_tensor().numpy()
            out[f"{t}/loss_{case}/dhead"] = head.grad.full_tensor().numpy()
        with torch.no_grad():
            try:
                tmodel.model_forward(params, cfg, batch["tokens"],
                                     mode="prefill")
            except NotImplementedError as e:
                out[f"{t}/serving_error"] = np.array(str(e))
        del params, opt

    # the elastic restart: the (2, 2) checkpoint on another mesh
    mesh = make_device_mesh(ELASTIC, ("data", "model"), "cpu")
    params = tmodel.init_params(cfg, seed=1, mesh=mesh, dtype=torch.float32)
    opt = init_opt_state(params, ocfg)
    restored, step_ = ckpt_store.restore_checkpoint(
        ckpt, tloop.checkpoint_state(params, opt))
    tloop.load_checkpoint_state(params, opt, restored)
    e = tag(ELASTIC)
    out[f"{e}/step"] = np.array(step_)
    out[f"{e}/opt_step"] = opt["step"].numpy()
    named = {n: p.detach() for n, p in params.named_parameters()}
    for what, tree in (("p", named), ("m", opt["m"]), ("v", opt["v"])):
        for k, v in _full_stacked(cfg, tree).items():
            out[f"{e}/{what}/{k}"] = v
    for name, p in params.named_parameters():
        out[f"{e}/placement/{name}"] = np.array(_placements(p))

    for which in UNCOVERED:
        c = (dataclasses.replace(cfg, **{which: True}) if which in
             ("ulysses_attn", "seq_sharded") else get_smoke_config(which))
        try:
            tmodel.init_params(c, mesh=mesh, dtype=torch.float32)
        except NotImplementedError as err:
            out[f"uncovered/{which}"] = np.array(str(err))
    if rank == 0:
        np.savez(dst, **out)
