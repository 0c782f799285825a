"""The port's side of ``tests/test_torch_mesh_train.py``,
``tests/test_torch_mesh_serve.py``, ``tests/test_torch_mesh_families.py``,
``tests/test_torch_mesh_sp.py`` and ``tests/test_torch_mesh_ssm.py``:
processes of one ``gloo`` group on the CPU, each running the same program
on its shard.

Imports ``torch`` and ``repro_torch`` only (a spawned process imports this
module to find its function).  :func:`spawn` starts ``world`` processes that
join a group through a file under a temporary directory (no TCP port, so
test files may run side by side) and run ``fn(rank, *args)``;
:func:`port_runs` (training), :func:`serve_runs` (serving),
:func:`family_runs` (the MoE and the encoder-decoder, both),
:func:`sp_runs` (``ulysses_attn`` and ``seq_sharded``) and
:func:`ssm_runs`/:func:`ssm_one` (the SSM and hybrid families, with the
sequence options and without) are the programs the tests hold against the
reference.
"""
from __future__ import annotations

import contextlib
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
LOSS_CHUNK = 16
#: the smoke configurations served on a mesh: GQA whose 2 KV heads do not
#: divide 4, the parallel block, MQA, sliding windows, M-RoPE with a visual
#: prefix
SERVED = ("qwen2_7b", "command_r_plus_104b", "granite_20b", "gemma3_4b",
          "qwen2_vl_7b")
#: the served batch: prompts of SERVE_SEQ (past Gemma3's smoke window of 16),
#: SERVE_STEPS greedy tokens (a prefill and SERVE_STEPS - 1 decode steps)
SERVE_BATCH, SERVE_SEQ, SERVE_STEPS = 4, 40, 4
#: the configurations whose ``init_params`` is held across meshes
INIT_HELD = ("qwen2_7b", "command_r_plus_104b")
INIT_SEED = 3
#: the MoE and encoder-decoder cases on a mesh, each with its meshes: the
#: smoke configs of Qwen2-MoE (shared experts, ``qkv_bias``), Granite-MoE
#: (no shared experts, ``router_norm``, tied head, 2 KV heads that do not
#: divide 4) and Whisper-small; Qwen2-MoE with 6 experts, which ``model``
#: of 4 does not divide (``expert_mlp`` takes it: TP inside each expert),
#: and at capacity factor 0.5 (drops, counted in global token order)
FAMILY_CASES = {"qwen2_moe": MESHES, "granite_moe": MESHES,
                "whisper": MESHES, "qwen2_moe_e6": ((1, 4),),
                "qwen2_moe_c05": MESHES}
#: the batch a family case trains on
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 4, 32


def family_config(case: str, get_smoke_config):
    """A :data:`FAMILY_CASES` case's config from ``get_smoke_config`` (the
    port's or the reference's: the same fields)."""
    import dataclasses
    arch = {"granite_moe": "granite_moe_3b_a800m",
            "whisper": "whisper_small"}.get(case, "qwen2_moe_a2_7b")
    cfg = get_smoke_config(arch)
    if case == "qwen2_moe_e6":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=6))
    if case == "qwen2_moe_c05":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    return cfg


def tag(shape) -> str:
    return "x".join(map(str, shape))


def _entry(rank: int, fn, world: int, init: str, args: tuple) -> None:
    torch.set_num_threads(1)
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


def train_inputs(path: str) -> dict:
    """Seeded numpy inputs: the smoke config's parameters (norm scales and
    biases random too), a (4, 32) batch with three labels masked, and the
    loss cases (a batch of 4, and of 3: the fallback on data = 2)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tmodel
    cfg = get_smoke_config("qwen2_7b")
    rng = np.random.default_rng(7)
    d = {}
    for k, t in tmodel.abstract_params(cfg).items():
        scale = 0.3 if k in tmodel.NORM_KEYS or k in ("bq", "bk", "bv") \
            else 0.02
        d["p/" + k] = (rng.standard_normal(tuple(t.shape)) * scale
                       ).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    lab[0, :3] = -1
    d["tokens"], d["labels"] = tok, lab
    for case, B in (("even", 4), ("odd", 3)):
        d[f"loss_{case}/x"] = rng.standard_normal((B, 40, 64)
                                                  ).astype(np.float32)
        d[f"loss_{case}/head"] = (rng.standard_normal((64, 512)) * 0.1
                                  ).astype(np.float32)
        lab = rng.integers(0, 500, (B, 40)).astype(np.int32)
        lab[0, :5] = -1
        d[f"loss_{case}/labels"] = lab
    d["valid_vocab"] = np.array(500)
    np.savez(path, **d)
    return d


def port_runs(rank: int, src: str, dst: str, ckpt: str) -> None:
    """On each mesh of :data:`MESHES`: one train step of the Qwen2-7B smoke
    config at fp32 from ``src``'s parameters and batch, the fused loss's
    two cases, the parameters' and constraints' placements; a checkpoint
    of the (2, 2) state under ``ckpt`` restored on :data:`ELASTIC`.
    Rank 0 writes ``dst`` (npz)."""
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
    if rank == 0:
        np.savez(dst, **out)


def _local_bytes(tensors) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in tensors)


def serve_runs(rank: int, shape: tuple, src: str, dst: str) -> None:
    """On the (data, model) mesh ``shape``, under the ``serve_tp`` rules at
    fp32, each configuration of :data:`SERVED` from ``src``'s parameters
    (``params_from_numpy``): the prefill's logits and caches, the caches
    after SERVE_STEPS - 1 decode steps of ``src``'s tokens, those steps'
    logits, ``greedy_generate``'s ids, the placements of the parameters
    and of the caches of ``init_cache`` and of the prefill, rank 0's local
    bytes, and the shapes the flash wrapper saw; the vocab-parallel lookup
    beside the plain one, in fp32 and bf16; :data:`INIT_HELD`'s
    ``init_params`` gathered whole.  Rank 0 writes ``dst`` (npz)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import attention
    from repro_torch.launch.dryrun import serve_tp_rules
    from repro_torch.launch.mesh import make_device_mesh, set_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.sharding import set_rules
    from repro_torch.serve import step as tstep
    tmodel.COMPUTE_DTYPE = torch.float32
    set_rules(serve_tp_rules())
    data = dict(np.load(src))
    mesh = make_device_mesh(shape, ("data", "model"), "cpu")
    seen = []
    plain_fwd = attention.flash_attention_fwd

    def counted_fwd(q, k, v, **kw):
        seen.append((type(q).__name__, tuple(q.shape), tuple(k.shape)))
        return plain_fwd(q, k, v, **kw)
    attention.flash_attention_fwd = counted_fwd
    out = {}
    B, S, steps = SERVE_BATCH, SERVE_SEQ, SERVE_STEPS
    for arch in SERVED:
        cfg = get_smoke_config(arch)
        key = f"{arch}/"
        flat = {k[len(key) + 2:]: v for k, v in data.items()
                if k.startswith(key + "p/")}
        params = tmodel.params_from_numpy(cfg, flat, mesh=mesh,
                                          dtype=torch.float32)
        for name, p in params.named_parameters():
            out[f"{arch}/placement/{name}"] = np.array(_placements(p))
        out[f"{arch}/local_bytes/params"] = np.array(
            _local_bytes(params.parameters()))
        empty = tmodel.init_cache(cfg, B, S + steps, mesh=mesh)
        for nm in ("k", "v"):
            out[f"{arch}/init_cache_placement/{nm}"] = np.array(
                _placements(empty[nm]))
        out[f"{arch}/local_bytes/cache"] = np.array(
            _local_bytes(empty[nm] for nm in ("k", "v")))
        assert empty["pos"] == 0
        del empty
        extra = {k: torch.from_numpy(data[f"{arch}/{k}"])
                 for k in ("visual", "mrope_positions")
                 if f"{arch}/{k}" in data}
        tokens = torch.from_numpy(data[f"{arch}/tokens"])
        prefill = tstep.make_prefill_step(cfg, max_len=S + steps)
        decode = tstep.make_decode_step(cfg)
        del seen[:]
        logits, cache = prefill(params, {"tokens": tokens, **extra})
        out[f"{arch}/flash_calls"] = np.array(repr(seen))
        out[f"{arch}/prefill_logits"] = logits.full_tensor().numpy()
        for nm in ("k", "v"):
            out[f"{arch}/cache_placement/{nm}"] = np.array(
                _placements(cache[nm]))
            out[f"{arch}/prefill_cache/{nm}"] = cache[nm].full_tensor(
                ).numpy()
        dec = []
        for i in range(steps - 1):
            logits, cache = decode(params, {
                "tokens": torch.from_numpy(data[f"{arch}/decode"][i]),
                "cache": cache})
            dec.append(logits.full_tensor().numpy())
        out[f"{arch}/decode_logits"] = np.stack(dec)
        out[f"{arch}/pos"] = np.array(cache["pos"])
        for nm in ("k", "v"):
            out[f"{arch}/decode_cache/{nm}"] = cache[nm].full_tensor(
                ).numpy()
        out[f"{arch}/greedy"] = tstep.greedy_generate(
            params, cfg, tokens, steps, **extra).numpy()
        del params, cache, logits

    cfg = get_smoke_config("qwen2_7b")
    tokens = torch.from_numpy(data["qwen2_7b/tokens"])
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        params = tmodel.params_from_numpy(cfg, {
            k[len("qwen2_7b/p/"):]: v for k, v in data.items()
            if k.startswith("qwen2_7b/p/")}, mesh=mesh, dtype=dt)
        with set_mesh(mesh):
            x = tmodel._embed(params, tmodel._replicated(
                params, tokens, ("batch", None)), dt)
        out[f"embed_{name}/placement"] = np.array(_placements(params.embed))
        out[f"embed_{name}/mesh"] = x.full_tensor().float().numpy()
        plain = tmodel.full_tensor(params.embed)[tokens.long()].to(dt)
        out[f"embed_{name}/bits_equal"] = np.array(bool(torch.equal(
            x.full_tensor().view(torch.int16 if dt == torch.bfloat16
                                 else torch.int32),
            plain.view(torch.int16 if dt == torch.bfloat16
                       else torch.int32))))
        del params

    for arch in INIT_HELD:
        cfg = get_smoke_config(arch)
        params = tmodel.init_params(cfg, seed=INIT_SEED, mesh=mesh,
                                    dtype=torch.float32)
        for k, v in tmodel.params_to_numpy(params).items():
            out[f"init/{arch}/{k}"] = v
        del params
    attention.flash_attention_fwd = plain_fwd
    if rank == 0:
        np.savez(dst, **out)


def _record_routing(calls: list):
    """Wrap ``models.moe.dispatch`` and ``_expert_sums`` to record, per MoE
    call, the experts (T, k), ``pos`` and ``keep`` every process ranked, and
    the local weights' shape and buffer block each process ran; returns
    the undo."""
    from repro_torch.models import moe
    dispatch, sums = moe.dispatch, moe._expert_sums

    def rec_dispatch(experts, num_experts, capacity):
        pos, keep = dispatch(experts, num_experts, capacity)
        calls.append({"experts": experts.numpy().copy(),
                      "pos": pos.numpy().copy(), "keep": keep.numpy().copy(),
                      "capacity": capacity})
        return pos, keep

    def rec_sums(xf, gates, experts, pos, keep, w_in, w_gate, w_out, act,
                 rows, cols):
        calls[-1]["block"] = (tuple(w_in.shape), tuple(w_out.shape), rows,
                              cols, tuple(xf.shape))
        return sums(xf, gates, experts, pos, keep, w_in, w_gate, w_out,
                    act, rows, cols)
    moe.dispatch, moe._expert_sums = rec_dispatch, rec_sums

    def undo():
        moe.dispatch, moe._expert_sums = dispatch, sums
    return undo


def _routing_out(out: dict, key: str, calls: list) -> None:
    for i, c in enumerate(calls):
        for name in ("experts", "pos", "keep"):
            out[f"{key}/{i}/{name}"] = c[name]
        out[f"{key}/{i}/block"] = np.array(repr(c.get("block")))


def family_runs(rank: int, shape: tuple, src: str, dst: str,
                ckpt: str) -> None:
    """On the (data, model) mesh ``shape``, each :data:`FAMILY_CASES` case
    that runs there, at fp32 from ``src``'s parameters:

    * under the ``serve_tp`` rules: the prefill's logits and caches, the
      caches and logits after SERVE_STEPS - 1 decode steps, the greedy ids,
      the prefill's routing (experts, ``pos``, ``keep``, each process's
      local weights and buffer block), the flash wrapper's shapes, the
      placements of the parameters and of ``init_cache``'s caches, rank 0's
      local bytes;
    * under the default rules: one train step (loss, ``grad_norm``, the
      updated parameters and moments gathered whole), the placements of
      the parameters and moments, the train forward's routing, and whether
      two runs of the loss and backward give the same gradients bit for
      bit.

    On (2, 2) Qwen2-MoE's trained state is checkpointed under ``ckpt`` and
    restored on :data:`ELASTIC`.  Rank 0 writes ``dst`` (npz)."""
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import attention
    from repro_torch.launch.dryrun import serve_tp_rules
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    from repro_torch.serve import step as sstep
    from repro_torch.train import loop as tloop
    from repro_torch.train import step as tstep
    tmodel.COMPUTE_DTYPE = torch.float32
    data = dict(np.load(src))
    mesh = make_device_mesh(shape, ("data", "model"), "cpu")
    ocfg = OptimConfig(warmup_steps=1, decay_steps=10)
    seen = []
    plain_fwd = attention.flash_attention_fwd

    def counted_fwd(q, k, v, **kw):
        seen.append((type(q).__name__, tuple(q.shape), tuple(k.shape),
                     kw.get("causal")))
        return plain_fwd(q, k, v, **kw)
    attention.flash_attention_fwd = counted_fwd
    out = {}
    B, S, steps = SERVE_BATCH, SERVE_SEQ, SERVE_STEPS
    for case, meshes in FAMILY_CASES.items():
        if shape not in meshes:
            continue
        cfg = family_config(case, get_smoke_config)
        flat = {k[len(case) + 3:]: v for k, v in data.items()
                if k.startswith(f"{case}/p/")}
        frames = ({"frames": torch.from_numpy(data[f"{case}/frames"])}
                  if cfg.enc_dec else {})
        names = [nm for nm in tmodel.CACHE_KEYS
                 if nm in tmodel.cache_logical(cfg)]

        # serving, under serve_tp
        set_rules(serve_tp_rules())
        params = tmodel.params_from_numpy(cfg, flat, mesh=mesh,
                                          dtype=torch.float32)
        for name, p in params.named_parameters():
            out[f"{case}/serve/placement/{name}"] = np.array(_placements(p))
        out[f"{case}/local_bytes/params"] = np.array(
            _local_bytes(params.parameters()))
        empty = tmodel.init_cache(cfg, B, S + steps, mesh=mesh)
        for nm in names:
            out[f"{case}/init_cache_placement/{nm}"] = np.array(
                _placements(empty[nm]))
        out[f"{case}/local_bytes/cache"] = np.array(
            _local_bytes(empty[nm] for nm in names))
        del empty
        tokens = torch.from_numpy(data[f"{case}/tokens"])
        prefill = sstep.make_prefill_step(cfg, max_len=S + steps)
        decode = sstep.make_decode_step(cfg)
        del seen[:]
        calls = []
        undo = _record_routing(calls)
        try:
            logits, cache = prefill(params, {"tokens": tokens, **frames})
        finally:
            undo()
        _routing_out(out, f"{case}/serve_routing", calls)
        out[f"{case}/flash_calls"] = np.array(repr(seen))
        out[f"{case}/prefill_logits"] = logits.full_tensor().numpy()
        for nm in names:
            out[f"{case}/cache_placement/{nm}"] = np.array(
                _placements(cache[nm]))
            out[f"{case}/prefill_cache/{nm}"] = cache[nm].full_tensor(
                ).numpy()
        dec = []
        for i in range(steps - 1):
            logits, cache = decode(params, {
                "tokens": torch.from_numpy(data[f"{case}/decode"][i]),
                "cache": cache})
            dec.append(logits.full_tensor().numpy())
        out[f"{case}/decode_logits"] = np.stack(dec)
        out[f"{case}/pos"] = np.array(cache["pos"])
        for nm in names:
            out[f"{case}/decode_cache/{nm}"] = cache[nm].full_tensor(
                ).numpy()
        out[f"{case}/greedy"] = sstep.greedy_generate(
            params, cfg, tokens, steps, **frames).numpy()
        del params, cache, logits

        # training, under the default rules
        set_rules(DEFAULT_RULES)
        params = tmodel.params_from_numpy(cfg, flat, mesh=mesh,
                                          dtype=torch.float32)
        opt = init_opt_state(params, ocfg)
        for name, p in params.named_parameters():
            out[f"{case}/train/placement/{name}"] = np.array(_placements(p))
            out[f"{case}/train/moment_placement/{name}"] = np.array(
                _placements(opt["m"][name]))
        batch = tloop.distribute_batch(
            {k: torch.from_numpy(data[f"{case}/train/{k}"])
             for k in ("tokens", "labels", "frames")
             if f"{case}/train/{k}" in data}, mesh)
        grads = []
        for _ in range(2):
            params.requires_grad_(True)
            calls = []
            undo = _record_routing(calls)
            try:
                loss, _ = tmodel.lm_loss(params, cfg, batch)
                loss.backward()
            finally:
                undo()
            grads.append({n: p.grad.to_local().clone()
                          for n, p in params.named_parameters()})
            params.zero_grad(set_to_none=True)
            params.requires_grad_(False)
        out[f"{case}/train_routing_calls"] = np.array(len(calls))
        _routing_out(out, f"{case}/train_routing", calls)
        out[f"{case}/grads_bit_identical"] = np.array(all(
            torch.equal(a.view(torch.int32), grads[1][n].view(torch.int32))
            for n, a in grads[0].items()))
        del grads
        step = tstep.make_train_step(cfg, tstep.TrainConfig(ocfg))
        params, opt, metrics = step(params, opt, batch)
        out[f"{case}/loss"] = metrics["loss"].numpy()
        out[f"{case}/grad_norm"] = metrics["grad_norm"].numpy()
        named = {n: p.detach() for n, p in params.named_parameters()}
        for what, tree in (("p", named), ("m", opt["m"]), ("v", opt["v"])):
            for k, v in _full_stacked(cfg, tree).items():
                out[f"{case}/{what}/{k}"] = v
        if case == "qwen2_moe" and shape == (2, 2):
            ckpt_store.save_checkpoint(ckpt, 1,
                                       tloop.checkpoint_state(params, opt))
            elastic = make_device_mesh(ELASTIC, ("data", "model"), "cpu")
            other = tmodel.init_params(cfg, seed=1, mesh=elastic,
                                       dtype=torch.float32)
            other_opt = init_opt_state(other, ocfg)
            restored, step_ = ckpt_store.restore_checkpoint(
                ckpt, tloop.checkpoint_state(other, other_opt))
            tloop.load_checkpoint_state(other, other_opt, restored)
            e = f"{case}/{tag(ELASTIC)}"
            out[f"{e}/step"] = np.array(step_)
            named = {n: p.detach() for n, p in other.named_parameters()}
            for what, tree in (("p", named), ("m", other_opt["m"]),
                               ("v", other_opt["v"])):
                for k, v in _full_stacked(cfg, tree).items():
                    out[f"{e}/{what}/{k}"] = v
            for name, p in other.named_parameters():
                out[f"{e}/placement/{name}"] = np.array(_placements(p))
            del other, other_opt
        del params, opt
    attention.flash_attention_fwd = plain_fwd
    set_rules(DEFAULT_RULES)
    if rank == 0:
        np.savez(dst, **out)


# ------------------------------------------------ ulysses_attn, seq_sharded
#: the smoke configurations run with the sequence options: GQA whose 2 KV
#: heads do not divide 4, MQA, sliding windows (16, below SP_SEQ), the MoE
#: and the encoder-decoder (cross-attention)
SP_ARCHS = ("qwen2_7b", "granite_20b", "gemma3_4b", "qwen2_moe_a2_7b",
            "whisper_small")
#: the option sets: each flips these fields of the config
SP_OPTIONS = {"ulysses": {"ulysses_attn": True},
              "seq": {"seq_sharded": True},
              "both": {"ulysses_attn": True, "seq_sharded": True}}
#: the configuration whose train step's collectives are counted, with no
#: option and with both
SP_COMM_ARCH = "qwen2_7b"
#: the batch of every case (training and prefill), and a sequence that
#: neither model axis of :data:`MESHES` divides (the fallback)
SP_BATCH, SP_SEQ, SP_ODD_SEQ = 4, 40, 41


def sp_config(arch: str, opts: str | None, get_smoke_config):
    """``arch``'s smoke config (the port's or the reference's) with the
    fields of :data:`SP_OPTIONS` ``[opts]`` set (none for None)."""
    import dataclasses
    return dataclasses.replace(get_smoke_config(arch),
                               **SP_OPTIONS.get(opts, {}))


def param_shapes(cfg) -> set:
    """Every shape a parameter of ``cfg`` (one layer's slice) or its
    flattened matrix takes in the model's products: the parameter-like
    shapes of :func:`_record_redistributions`."""
    from repro_torch.models import model as tmodel
    out = set()
    for name, t in tmodel.abstract_params(cfg).items():
        shape = tuple(t.shape if name in tmodel.GLOBAL_KEYS
                      else t.shape[1:])
        out.add(shape)
        if len(shape) > 2:
            out.add((shape[0], int(np.prod(shape[1:]))))
            out.add((int(np.prod(shape[:-1])), shape[-1]))
    return out


def _record_redistributions(calls: list):
    """Wrap DTensor's ``redistribute_local_tensor`` (as its explicit
    redistributions and its operators' implicit ones call it) to record
    each call's shape and the placements it went from and to; returns the
    undo."""
    from torch.distributed.tensor import _dispatch, _redistribute
    saved = _redistribute.redistribute_local_tensor

    def rec(local, current, target, **kw):
        calls.append((tuple(current.shape),
                      tuple(repr(p) for p in current.placements),
                      tuple(repr(p) for p in target.placements)))
        return saved(local, current, target, **kw)
    _redistribute.redistribute_local_tensor = rec
    _dispatch.redistribute_local_tensor = rec

    def undo():
        _redistribute.redistribute_local_tensor = saved
        _dispatch.redistribute_local_tensor = saved
    return undo


def _gathered_over_model(calls: list, shapes: set) -> list:
    """The recorded redistributions of a parameter-like shape that take a
    tensor split over ``model`` (the second mesh axis) whole there."""
    return sorted({repr(c) for c in calls if c[0] in shapes
                   and "Shard(" in c[1][1] and c[2][1] == "Replicate()"})


def _record_flash(seen: list):
    """Wrap the flash kernels' wrappers (as ``models.flash`` calls them) to
    record each call's type and shapes of q and k, its ``q_offset`` and
    ``causal``; returns the undo."""
    from repro_torch.kernels import attention
    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd

    def rec_fwd(q, k, v, **kw):
        seen.append(("fwd", type(q).__name__, tuple(q.shape),
                     tuple(k.shape), kw.get("q_offset", 0),
                     kw.get("causal")))
        return fwd(q, k, v, **kw)

    def rec_bwd(q, k, v, out, lse, dout, **kw):
        seen.append(("bwd", type(q).__name__, tuple(q.shape),
                     tuple(k.shape), kw.get("q_offset", 0),
                     kw.get("causal")))
        return bwd(q, k, v, out, lse, dout, **kw)
    attention.flash_attention_fwd = rec_fwd
    attention.flash_attention_bwd = rec_bwd

    def undo():
        attention.flash_attention_fwd, attention.flash_attention_bwd = \
            fwd, bwd
    return undo


def sp_runs(rank: int, shape: tuple, src: str, dst: str) -> None:
    """On the (data, model) mesh ``shape``, at fp32 from ``src``'s
    parameters and batches, for each :data:`SP_ARCHS` configuration:

    * under the default rules, for each option set of
      :data:`SP_OPTIONS`: one ``make_train_step`` step (its loss, the
      gradients it applied, the parameters after it, gathered whole); every
      process's flash calls (shapes, ``q_offset``, ``causal``); each
      layer's output placements; the redistributions of a parameter-like
      shape that gathered it whole over ``model`` (and so, once more, with
      no option); for :data:`SP_COMM_ARCH` with no option and with both,
      ``CommDebugMode``'s collective counts;
    * under ``serve_tp`` with ``ulysses_attn``: the prefill's logits and
      caches and every process's flash calls.

    Then Qwen2-7B's prefill with ``ulysses_attn`` at :data:`SP_ODD_SEQ`
    positions (the fallback), its logits and flash calls.  Rank 0 writes
    ``dst`` (npz)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import serve_tp_rules
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    from repro_torch.serve import step as sstep
    from repro_torch.train import loop as tloop
    from repro_torch.train import step as tstep
    tmodel.COMPUTE_DTYPE = torch.float32
    data = dict(np.load(src))
    mesh = make_device_mesh(shape, ("data", "model"), "cpu")
    ocfg = OptimConfig(warmup_steps=1, decay_steps=10)
    world = dist.get_world_size()
    out = {}

    def every_rank(seen: list) -> str:
        """Every process's records, in rank order."""
        got = [None] * world
        dist.all_gather_object(got, list(seen))
        return repr(got)

    applied = {}
    apply_updates = tstep.apply_updates

    def keep_grads(named, grads, opt_state, *a, **kw):
        applied.update({n: g.clone() for n, g in grads.items()})
        return apply_updates(named, grads, opt_state, *a, **kw)
    tstep.apply_updates = keep_grads
    try:
        for arch in SP_ARCHS:
            key = f"{arch}/"
            flat = {k[len(key) + 2:]: v for k, v in data.items()
                    if k.startswith(key + "p/")}
            shapes = param_shapes(get_smoke_config(arch))
            set_rules(DEFAULT_RULES)
            for opts in (None, *SP_OPTIONS):
                cfg = sp_config(arch, opts, get_smoke_config)
                t = f"{arch}/{opts or 'none'}"
                params = tmodel.params_from_numpy(cfg, flat, mesh=mesh,
                                                  dtype=torch.float32)
                opt = init_opt_state(params, ocfg)
                batch = tloop.distribute_batch(
                    {k: torch.from_numpy(data[f"{key}train/{k}"])
                     for k in ("tokens", "labels", "frames")
                     if f"{key}train/{k}" in data}, mesh)
                seen, redist, carry = [], [], []
                hooks = [layer.register_forward_hook(
                    lambda m, a, y: carry.append(repr(tuple(y.placements))))
                    for layer in params.layers]
                undo = [_record_flash(seen), _record_redistributions(redist)]
                applied.clear()
                try:
                    # the collectives of one step, counted where
                    # SP_COMM_ARCH takes no option and both (the counter
                    # doubles a step's time on the CPU)
                    counting = arch == SP_COMM_ARCH and opts in (None, "both")
                    with (CommDebugMode() if counting
                          else contextlib.nullcontext()) as comm:
                        step = tstep.make_train_step(cfg,
                                                     tstep.TrainConfig(ocfg))
                        params, opt, metrics = step(params, opt, batch)
                finally:
                    for u in undo:
                        u()
                    for h in hooks:
                        h.remove()
                out[f"{t}/gathered"] = np.array(
                    _gathered_over_model(redist, shapes), dtype=object
                    ).astype(str)
                if counting:
                    out[f"{t}/comm"] = np.array(repr(sorted(
                        (str(k), v)
                        for k, v in comm.get_comm_counts().items())))
                if opts is None:
                    continue
                out[f"{t}/loss"] = metrics["loss"].numpy()
                out[f"{t}/flash"] = np.array(every_rank(seen))
                out[f"{t}/carry"] = np.array(repr(carry))
                names = dict(params.named_parameters())
                for k, v in _full_stacked(cfg, {
                        n: applied[n] for n in names}).items():
                    out[f"{t}/g/{k}"] = v
                named = {n: p.detach() for n, p in names.items()}
                for k, v in _full_stacked(cfg, named).items():
                    out[f"{t}/p/{k}"] = v
                del params, opt, metrics, step

            # serving, under serve_tp, with ulysses_attn
            set_rules(serve_tp_rules())
            cfg = sp_config(arch, "ulysses", get_smoke_config)
            params = tmodel.params_from_numpy(cfg, flat, mesh=mesh,
                                              dtype=torch.float32)
            extra = ({"frames": torch.from_numpy(data[f"{key}frames"])}
                     if cfg.enc_dec else {})
            seen = []
            undo = _record_flash(seen)
            try:
                logits, cache = sstep.make_prefill_step(
                    cfg, max_len=SP_SEQ + 2)(params, {
                        "tokens": torch.from_numpy(data[f"{key}tokens"]),
                        **extra})
            finally:
                undo()
            out[f"{arch}/serve/flash"] = np.array(every_rank(seen))
            out[f"{arch}/serve/prefill_logits"] = logits.full_tensor().numpy()
            for nm in ("k", "v", "xk", "xv"):
                if nm in cache:
                    out[f"{arch}/serve/prefill_cache/{nm}"] = \
                        cache[nm].full_tensor().numpy()
            del params, cache, logits

        # the fallback: a sequence that ``model`` does not divide
        cfg = sp_config("qwen2_7b", "ulysses", get_smoke_config)
        params = tmodel.params_from_numpy(cfg, {
            k[len("qwen2_7b/p/"):]: v for k, v in data.items()
            if k.startswith("qwen2_7b/p/")}, mesh=mesh, dtype=torch.float32)
        seen = []
        undo = _record_flash(seen)
        try:
            logits, _ = sstep.make_prefill_step(cfg)(params, {
                "tokens": torch.from_numpy(data["odd/tokens"])})
        finally:
            undo()
        out["odd/flash"] = np.array(every_rank(seen))
        out["odd/prefill_logits"] = logits.full_tensor().numpy()
    finally:
        tstep.apply_updates = apply_updates
        set_rules(DEFAULT_RULES)
    if rank == 0:
        np.savez(dst, **out)


# ------------------------------------------------- the SSM and hybrid blocks
#: the SSM and hybrid cases on a mesh: the smoke configs of Mamba2 (whose
#: ``in_proj`` columns and conv channels straddle z | xBC | dt and x | B | C
#: on ``model`` of 4) and Hymba (GQA 4 / 2: ``head_dim`` takes ``model`` of
#: 4 for k and v), and Hymba at d_model 72, whose SSM widths repeat the
#: published Hymba's divisibility on ``model`` of 4 (d_proj 322 and 18 SSM
#: heads whole, conv_dim 160 split, d_inner 144 split mid-head)
SSM_CASES = {"mamba2": MESHES, "hymba": MESHES, "hymba_w72": MESHES}
#: the sequence options every SSM case also runs with (names of
#: :data:`SP_OPTIONS`): each trains; serving takes ``ulysses_attn`` alone
#: (``seq_sharded`` acts in training only, as in the reference)
SSM_OPTIONS = ("ulysses", "seq", "both")
#: the case whose (2, 2) checkpoint restores on :data:`ELASTIC` and off
#: any mesh
SSM_CKPT = "mamba2"
#: the SSM cases' tolerances, each of an array's largest magnitude: the
#: logits, the ``conv``/``ssm`` caches and the gradients
LOGIT_FRAC, CACHE_FRAC, GRAD_FRAC = 1e-4, 1e-5, 1e-5
#: which outputs of :func:`ssm_runs` each of them holds
SSM_FRAC = {"prefill_logits": LOGIT_FRAC, "decode_logits": LOGIT_FRAC,
            "prefill_cache": CACHE_FRAC, "decode_cache": CACHE_FRAC,
            "g": GRAD_FRAC}


def ssm_config(case: str, get_smoke_config):
    """A :data:`SSM_CASES` case's config from ``get_smoke_config`` (the
    port's or the reference's)."""
    import dataclasses
    if case == "mamba2":
        return get_smoke_config("mamba2_2_7b")
    cfg = get_smoke_config("hymba_1_5b")
    return dataclasses.replace(cfg, d_model=72) if case == "hymba_w72" \
        else cfg


def ssm_inputs(path: str) -> dict:
    """Seeded numpy inputs for every :data:`SSM_CASES` case, written to
    ``path`` (npz) and returned: its parameters (norm scales, the conv's
    weights and bias, dt bias, A_log and D at scale 0.3, the matrices at
    0.02), prompts, the decode steps' tokens and a train batch (labels
    rolled, three masked)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as tmodel
    B, S, steps = SERVE_BATCH, SERVE_SEQ, SERVE_STEPS
    rng = np.random.default_rng(32)
    d = {}
    for case in SSM_CASES:
        cfg = ssm_config(case, get_smoke_config)
        for k, t in tmodel.abstract_params(cfg).items():
            scale = 0.3 if k in tmodel.NORM_KEYS or k in \
                tmodel.SSM_FP32_KEYS else 0.02
            d[f"{case}/p/{k}"] = (rng.standard_normal(tuple(t.shape)) * scale
                                  ).astype(np.float32)
        d[f"{case}/tokens"] = rng.integers(0, cfg.vocab_size, (B, S)
                                           ).astype(np.int32)
        d[f"{case}/decode"] = rng.integers(0, cfg.vocab_size,
                                           (steps - 1, B, 1)).astype(np.int32)
        tok = rng.integers(0, cfg.vocab_size, (FAMILY_TRAIN_BATCH,
                                               FAMILY_TRAIN_SEQ)
                           ).astype(np.int32)
        lab = np.roll(tok, -1, 1)
        lab[0, :3] = -1
        d[f"{case}/train/tokens"], d[f"{case}/train/labels"] = tok, lab
    np.savez(path, **d)
    return d


def _whole(t) -> np.ndarray:
    """A (DTensor) tensor gathered whole, as a numpy copy."""
    from repro_torch.models.model import full_tensor
    return full_tensor(t).detach().float().numpy().copy()


def _record_states(seen: list):
    """Wrap ``models.ssm.mamba2_mix`` (as ``models.model`` calls it) to
    record the local shapes and placements of the states each call
    returns; returns the undo."""
    from repro_torch.models import ssm
    saved = ssm.mamba2_mix

    def rec(p, x, cfg, **kw):
        y, new = saved(p, x, cfg, **kw)
        seen.append(tuple((tuple(t.to_local().shape), _placements(t))
                          for t in (new["conv"], new["ssm"])))
        return y, new
    ssm.mamba2_mix = rec

    def undo():
        ssm.mamba2_mix = saved
    return undo


def _every_rank(seen: list) -> np.ndarray:
    """Every process's records, in rank order."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, list(seen))
    return np.array(repr(got))


def _ssm_serve(out: dict, case: str, cfg, flat: dict, data: dict, mesh,
               record: bool, key: str | None = None) -> None:
    """The serving run of one case at fp32 under the ``serve_tp`` rules,
    on ``mesh`` (or off any mesh for None): the prefill's logits and
    caches, SERVE_STEPS - 1 decode steps' logits and caches, the greedy
    ids; with ``record`` also the placements and local bytes, every
    process's flash calls and returned states, and the redistributions of
    the prefill and the decode steps.  Written under ``key`` (default
    ``case``)."""
    from repro_torch.launch.dryrun import serve_tp_rules
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.sharding import set_rules
    from repro_torch.serve import step as sstep
    set_rules(serve_tp_rules())
    B, S, steps = SERVE_BATCH, SERVE_SEQ, SERVE_STEPS
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    params = tmodel.params_from_numpy(cfg, flat, dtype=torch.float32, **kw)
    names = [n for n in tmodel.CACHE_KEYS if n in tmodel.cache_logical(cfg)]
    tokens = torch.from_numpy(data[f"{case}/tokens"])
    decode_tokens = data[f"{case}/decode"]
    case = key or case
    if record:
        for name, p in params.named_parameters():
            out[f"{case}/serve/placement/{name}"] = np.array(_placements(p))
        out[f"{case}/local_bytes/params"] = np.array(
            _local_bytes(params.parameters()))
        empty = tmodel.init_cache(cfg, B, S + steps, mesh=mesh)
        for nm in names:
            out[f"{case}/init_cache_placement/{nm}"] = np.array(
                _placements(empty[nm]))
        out[f"{case}/local_bytes/cache"] = np.array(
            _local_bytes(empty[nm] for nm in names))
        del empty
    prefill = sstep.make_prefill_step(cfg, max_len=S + steps)
    decode = sstep.make_decode_step(cfg)
    flash, states, redist = [], [], []
    undo = ([_record_flash(flash), _record_states(states),
             _record_redistributions(redist)] if record else [])
    try:
        logits, cache = prefill(params, {"tokens": tokens})
        mine = len(redist)          # the records' own gathers are not kept
        out[f"{case}/prefill_logits"] = _whole(logits)
        for nm in names:
            out[f"{case}/prefill_cache/{nm}"] = _whole(cache[nm])
            if record:
                out[f"{case}/cache_placement/{nm}"] = np.array(
                    _placements(cache[nm]))
                out[f"{case}/cache_local_shape/{nm}"] = np.array(
                    cache[nm].to_local().shape[1:])
        del redist[mine:]
        dec = []
        for i in range(steps - 1):
            logits, cache = decode(params, {
                "tokens": torch.from_numpy(decode_tokens[i]),
                "cache": cache})
            mine = len(redist)
            dec.append(_whole(logits))
            del redist[mine:]
    finally:
        for u in undo:
            u()
    out[f"{case}/decode_logits"] = np.stack(dec)
    out[f"{case}/pos"] = np.array(cache["pos"])
    for nm in names:
        out[f"{case}/decode_cache/{nm}"] = _whole(cache[nm])
    if record:
        out[f"{case}/flash_calls"] = _every_rank(flash)
        out[f"{case}/states"] = _every_rank(states)
        out[f"{case}/redistributed"] = _every_rank(sorted(set(redist)))
    out[f"{case}/greedy"] = sstep.greedy_generate(params, cfg, tokens,
                                                  steps).numpy()


def _ssm_train(out: dict, case: str, cfg, flat: dict, data: dict, mesh,
               record: bool):
    """The training run of one case at fp32 under the default rules, on
    ``mesh`` (or off any mesh for None): the loss and every gradient of
    two runs of the loss and backward (and whether the two are
    bit-identical), then one train step (loss, ``grad_norm``, parameters
    and moments gathered whole); with ``record`` the placements of the
    parameters and moments.  Returns (params, opt) after the step."""
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    from repro_torch.train import loop as tloop
    from repro_torch.train import step as tstep
    set_rules(DEFAULT_RULES)
    ocfg = OptimConfig(warmup_steps=1, decay_steps=10)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    params = tmodel.params_from_numpy(cfg, flat, dtype=torch.float32, **kw)
    opt = init_opt_state(params, ocfg)
    if record:
        for name, p in params.named_parameters():
            out[f"{case}/train/placement/{name}"] = np.array(_placements(p))
            out[f"{case}/train/moment_placement/{name}"] = np.array(
                _placements(opt["m"][name]))
    batch = {k: torch.from_numpy(data[f"{case}/train/{k}"])
             for k in ("tokens", "labels")}
    if mesh is not None:
        batch = tloop.distribute_batch(batch, mesh)
    grads = []
    for _ in range(2):
        params.requires_grad_(True)
        loss, _ = tmodel.lm_loss(params, cfg, batch)
        loss.backward()
        grads.append({n: getattr(p.grad, "to_local", lambda: p.grad)()
                      .clone() for n, p in params.named_parameters()})
        out[f"{case}/grad_loss"] = _whole(loss)
        for k, v in _full_stacked(cfg, {
                n: p.grad for n, p in params.named_parameters()}).items():
            out[f"{case}/g/{k}"] = v
        params.zero_grad(set_to_none=True)
        params.requires_grad_(False)
    out[f"{case}/grads_bit_identical"] = np.array(all(
        torch.equal(a.view(torch.int32), grads[1][n].view(torch.int32))
        for n, a in grads[0].items()))
    del grads
    step = tstep.make_train_step(cfg, tstep.TrainConfig(ocfg))
    params, opt, metrics = step(params, opt, batch)
    out[f"{case}/loss"] = _whole(metrics["loss"])
    out[f"{case}/grad_norm"] = _whole(metrics["grad_norm"])
    named = {n: p.detach() for n, p in params.named_parameters()}
    for what, tree in (("p", named), ("m", opt["m"]), ("v", opt["v"])):
        for k, v in _full_stacked(cfg, tree).items():
            out[f"{case}/{what}/{k}"] = v
    return params, opt


def _ssm_option_train(out: dict, case: str, opts: str, cfg, flat: dict,
                      data: dict, mesh) -> None:
    """One ``make_train_step`` step of one case with the sequence options
    ``opts`` (:data:`SP_OPTIONS`) at fp32 under the default rules, on
    ``mesh`` (or off any mesh for None), under ``<case>/<opts>/``: the
    loss, ``grad_norm``, the gradients the step applied and the
    parameters and moments after it, gathered whole; on a mesh also every
    process's flash calls and each layer's output placements."""
    import dataclasses

    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    from repro_torch.train import loop as tloop
    from repro_torch.train import step as tstep
    set_rules(DEFAULT_RULES)
    cfg = dataclasses.replace(cfg, **SP_OPTIONS[opts])
    ocfg = OptimConfig(warmup_steps=1, decay_steps=10)
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    params = tmodel.params_from_numpy(cfg, flat, dtype=torch.float32, **kw)
    opt = init_opt_state(params, ocfg)
    batch = {k: torch.from_numpy(data[f"{case}/train/{k}"])
             for k in ("tokens", "labels")}
    if mesh is not None:
        batch = tloop.distribute_batch(batch, mesh)
    applied, seen, carry = {}, [], []
    apply_updates = tstep.apply_updates

    def keep_grads(named, grads, opt_state, *a, **kw_):
        applied.update({n: g.detach().clone() for n, g in grads.items()})
        return apply_updates(named, grads, opt_state, *a, **kw_)
    tstep.apply_updates = keep_grads
    hooks = [layer.register_forward_hook(lambda m, a, y: carry.append(
        _placements(y))) for layer in params.layers]
    undo = _record_flash(seen)
    try:
        step = tstep.make_train_step(cfg, tstep.TrainConfig(ocfg))
        params, opt, metrics = step(params, opt, batch)
    finally:
        undo()
        for h in hooks:
            h.remove()
        tstep.apply_updates = apply_updates
    key = f"{case}/{opts}"
    out[f"{key}/loss"] = _whole(metrics["loss"])
    out[f"{key}/grad_norm"] = _whole(metrics["grad_norm"])
    named = {n: p.detach() for n, p in params.named_parameters()}
    for what, tree in (("g", applied), ("p", named), ("m", opt["m"]),
                       ("v", opt["v"])):
        for k, v in _full_stacked(cfg, tree).items():
            out[f"{key}/{what}/{k}"] = v
    out[f"{key}/flash"] = _every_rank(seen)
    out[f"{key}/carry"] = np.array(repr(sorted(set(carry))))


def _ssm_options(out: dict, case: str, cfg, flat: dict, data: dict, mesh,
                 record: bool) -> None:
    """Each :data:`SSM_OPTIONS` train step of one case
    (:func:`_ssm_option_train`) and its serving run with ``ulysses_attn``
    (:func:`_ssm_serve`, under ``<case>/ulysses/``) on ``mesh``."""
    import dataclasses
    for opts in SSM_OPTIONS:
        _ssm_option_train(out, case, opts, cfg, flat, data, mesh)
    _ssm_serve(out, case, dataclasses.replace(cfg, ulysses_attn=True), flat,
               data, mesh, record, key=f"{case}/ulysses")


def _ssm_flat(data: dict, case: str) -> dict:
    return {k[len(case) + 3:]: v for k, v in data.items()
            if k.startswith(f"{case}/p/")}


def ssm_runs(rank: int, shape: tuple, src: str, dst: str, ckpt: str
             ) -> None:
    """On the (data, model) mesh ``shape``, each :data:`SSM_CASES` case at
    fp32 from ``src``'s parameters: the serving run under ``serve_tp`` and
    the training run under the default rules (:func:`_ssm_serve`,
    :func:`_ssm_train`, recorded), the same with the sequence options
    (:func:`_ssm_options`), and the loss and gradients of one
    sequence (a batch of 1, which no data axis splits).  On (2, 2)
    :data:`SSM_CKPT`'s trained state is checkpointed under ``ckpt`` and
    restored on :data:`ELASTIC` and off any mesh.  Rank 0 writes ``dst``
    (npz)."""
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.optim.adamw import OptimConfig, init_opt_state
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    from repro_torch.train import loop as tloop
    tmodel.COMPUTE_DTYPE = torch.float32
    data = dict(np.load(src))
    mesh = make_device_mesh(shape, ("data", "model"), "cpu")
    ocfg = OptimConfig(warmup_steps=1, decay_steps=10)
    out = {}
    try:
        for case, meshes in SSM_CASES.items():
            if shape not in meshes:
                continue
            cfg = ssm_config(case, get_smoke_config)
            flat = _ssm_flat(data, case)
            _ssm_serve(out, case, cfg, flat, data, mesh, True)
            _ssm_options(out, case, cfg, flat, data, mesh, True)
            params, opt = _ssm_train(out, case, cfg, flat, data, mesh, True)
            if case == SSM_CKPT and shape == (2, 2):
                ckpt_store.save_checkpoint(
                    ckpt, 1, tloop.checkpoint_state(params, opt))
                for where in (ELASTIC, None):
                    kw = ({"mesh": make_device_mesh(where, ("data", "model"),
                                                    "cpu")}
                          if where else {"device": "cpu"})
                    other = tmodel.init_params(cfg, seed=1,
                                               dtype=torch.float32, **kw)
                    other_opt = init_opt_state(other, ocfg)
                    restored, step_ = ckpt_store.restore_checkpoint(
                        ckpt, tloop.checkpoint_state(other, other_opt))
                    tloop.load_checkpoint_state(other, other_opt, restored)
                    e = f"{case}/{tag(where) if where else 'off'}"
                    out[f"{e}/step"] = np.array(step_)
                    named = {n: p.detach()
                             for n, p in other.named_parameters()}
                    for what, tree in (("p", named), ("m", other_opt["m"]),
                                       ("v", other_opt["v"])):
                        for k, v in _full_stacked(cfg, tree).items():
                            out[f"{e}/{what}/{k}"] = v
                    for name, p in other.named_parameters():
                        if where:
                            out[f"{e}/placement/{name}"] = np.array(
                                _placements(p))
                    del other, other_opt
            del params, opt
            # one sequence: a batch of 1 stays whole on the data axis
            set_rules(DEFAULT_RULES)
            params = tmodel.params_from_numpy(cfg, flat, mesh=mesh,
                                              dtype=torch.float32)
            batch = tloop.distribute_batch(
                {k: torch.from_numpy(data[f"{case}/train/{k}"][:1])
                 for k in ("tokens", "labels")}, mesh)
            params.requires_grad_(True)
            loss, _ = tmodel.lm_loss(params, cfg, batch)
            loss.backward()
            out[f"{case}/one/loss"] = _whole(loss)
            for k, v in _full_stacked(cfg, {
                    n: p.grad for n, p in params.named_parameters()}).items():
                out[f"{case}/one/g/{k}"] = v
            del params
    finally:
        set_rules(DEFAULT_RULES)
    if rank == 0:
        np.savez(dst, **out)


def ssm_one(rank: int, src: str, dst: str) -> None:
    """In one process: each :data:`SSM_CASES` case's serving and training
    runs (:func:`_ssm_serve`, :func:`_ssm_train`) on a (1, 1) device mesh
    (keys ``mesh/...``; with the sequence options, :func:`_ssm_options`,
    ``opt/...``) and off any mesh (``off/...``), for the bit-for-bit
    comparison, and the one-sequence loss and gradients off
    any mesh (``off/<case>/one/...``).  Writes ``dst`` (npz)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.parallel.sharding import DEFAULT_RULES, set_rules
    tmodel.COMPUTE_DTYPE = torch.float32
    data = dict(np.load(src))
    mesh = make_device_mesh((1, 1), ("data", "model"), "cpu")
    out = {}
    try:
        for case in SSM_CASES:
            cfg = ssm_config(case, get_smoke_config)
            flat = _ssm_flat(data, case)
            for where, m in (("mesh", mesh), ("off", None)):
                got = {}
                _ssm_serve(got, case, cfg, flat, data, m, False)
                _ssm_train(got, case, cfg, flat, data, m, False)
                out.update({f"{where}/{k}": v for k, v in got.items()})
            got = {}
            _ssm_options(got, case, cfg, flat, data, mesh, False)
            out.update({f"opt/{k}": v for k, v in got.items()})
            set_rules(DEFAULT_RULES)
            params = tmodel.params_from_numpy(cfg, flat, device="cpu",
                                              dtype=torch.float32)
            params.requires_grad_(True)
            loss, _ = tmodel.lm_loss(params, cfg, {
                k: torch.from_numpy(data[f"{case}/train/{k}"][:1])
                for k in ("tokens", "labels")})
            loss.backward()
            out[f"off/{case}/one/loss"] = _whole(loss)
            for k, v in _full_stacked(cfg, {
                    n: p.grad for n, p in params.named_parameters()}).items():
                out[f"off/{case}/one/g/{k}"] = v
    finally:
        set_rules(DEFAULT_RULES)
    np.savez(dst, **out)
