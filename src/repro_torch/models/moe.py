"""Mixture-of-Experts FFN: top-k routing with capacity buffers.

The port's twin of ``repro.models.moe``.  Assignments are sorted by expert
(a stable sort, so earlier tokens take an expert's slots first) and copied
into a dense (E, C, d_model) buffer, one grouped product per expert
matrix; assignments past an expert's capacity C are dropped.  Shared
experts (Qwen2-MoE) are one wide gated MLP under a sigmoid gate.

Every shape is static and nothing reads a value back to the host: the
expert starts come from ``searchsorted`` over the sorted assignments (not
``bincount``, which sizes its output from the data on the card), and the k
gate-weighted contributions of a token are summed through a (T, k, d)
view, where ``index_add_`` on the card would add in no fixed order.

The backward is deterministic as well.  The token rows enter the buffer
through an expanded view, (T, d) -> (T, k, d) -> (T*k, d), whose backward
sums each token's k rows in a fixed order (an index gather would sum them
by ``index_put_(accumulate=True)``, in no fixed order on the card).  The
other index ops have unique slots: each kept assignment owns its buffer
row, the dropped ones all go to the drop row, which is cut off, and their
gather back carries a zero weight.

On a device mesh (x a DTensor) the dispatch runs under ``local_map`` with
explicit collectives, since DTensor has no sharding rule for the sort,
``searchsorted`` or the index assignment.  Each process routes its own
rows of tokens; the routings (T, k) are gathered over the data axes, so
every process computes the same ``pos`` and ``keep`` from the global
T = B * S in global token order (the one-device semantics: the same
capacity, the same drops).  The buffer is placed as the reference's
constraints say (``("experts", "batch", None)``; the hidden on
``("experts", "batch", "expert_mlp")``): a process holds the buffer rows
of its own experts (expert parallelism, where ``model`` divides the
experts) or of every expert with its slice of ``expert_mlp`` (tensor
parallelism inside each expert), and its slice of the capacity over the
data axes, and reads only its own experts' weights (the FSDP shards
gathered over ``data``).  Every process reads the tokens gathered whole
and returns its partial sums, which are reduced onto the token rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp


def _capacity(T: int, top_k: int, num_experts: int, factor: float) -> int:
    c = int(T * top_k * factor / num_experts) + 1
    return -(-c // 8) * 8     # pad to 8, as the reference does


def route(x: torch.Tensor, router: torch.Tensor, spec
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Router logits in x's dtype, softmax in fp32, the top k by a stable
    descending sort (ties to the lower expert index, as ``jax.lax.top_k``;
    ``torch.topk`` promises no order).  x (T, d) -> (gates (T, k) fp32,
    experts (T, k) int64), gates renormalised under ``router_norm``."""
    probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :spec.top_k], experts[:, :spec.top_k]
    if spec.router_norm:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return gates, experts


def dispatch(experts: torch.Tensor, num_experts: int, capacity: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each assignment's rank within its expert, in token order (a stable
    sort by expert), and ``keep = rank < capacity``.  experts (T, k) ->
    (pos (T*k,), keep (T*k,))."""
    a_expert = experts.reshape(-1)
    order = torch.sort(a_expert, stable=True).indices
    sorted_expert = a_expert[order]
    starts = torch.searchsorted(
        sorted_expert, torch.arange(num_experts, device=a_expert.device))
    pos = torch.empty_like(a_expert)
    pos[order] = (torch.arange(a_expert.numel(), device=a_expert.device)
                  - starts[sorted_expert])
    return pos, pos < capacity


def _expert_sums(xf, gates, experts, pos, keep, w_in, w_gate, w_out,
                 act: str, rows: tuple, cols: tuple) -> torch.Tensor:
    """The gate-weighted expert outputs of the buffer block of experts
    ``rows`` (first, count) and capacity slots ``cols`` (first, count),
    summed a token: xf (T, d), gates/experts (T, k), pos/keep (T*k,), the
    weights of those experts (w_in/w_gate (n_e, d, f), w_out (n_e, f, d))
    -> (T, d).  The assignments held elsewhere (and the dropped ones) go to
    the drop row and carry a zero weight.  With the whole buffer (every
    expert and slot) this is the one-device computation."""
    T, d = xf.shape
    k = experts.shape[1]
    dt = xf.dtype
    (e0, n_e), (c0, n_c) = rows, cols
    a_expert = experts.reshape(-1)
    mine = (keep & (a_expert >= e0) & (a_expert < e0 + n_e)
            & (pos >= c0) & (pos < c0 + n_c))
    n = n_e * n_c
    # the buffer's last row takes the assignments not held here; cut off
    slot = torch.where(mine, (a_expert - e0) * n_c + pos - c0, n)
    buf = torch.zeros((n + 1, d), dtype=dt, device=xf.device)
    buf[slot] = xf[:, None].expand(T, k, d).reshape(T * k, d)
    buf = buf[:-1].view(n_e, n_c, d)

    h = torch.bmm(buf, w_in.to(dt))
    if act in ("silu", "geglu"):
        g = torch.bmm(buf, w_gate.to(dt))
        g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        h = g * h
    else:
        h = F.gelu(h, approximate="tanh")
    y_buf = torch.bmm(h, w_out.to(dt)).view(n, d)

    # gather back with gate weights (the others contribute 0)
    contrib = y_buf[slot.clamp(max=n - 1)] * (
        gates.reshape(-1) * mine).to(dt)[:, None]
    return contrib.view(T, k, d).sum(dim=1)


def moe_ffn(x: torch.Tensor, p: dict, spec, act: str = "silu"
            ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  p: router (d, E); experts w_gate/w_in
    (E_buf, d, fe), w_out (E_buf, fe, d); optional shared_* for the shared
    experts (w_gate/w_in (d, fs), w_out (fs, d), gate (d, 1)).  A DTensor x
    (a device mesh) is dispatched by :func:`_routed_on_mesh`."""
    B, S, d = x.shape
    T = B * S
    E, k = spec.num_experts, spec.top_k
    E_buf = spec.padded_experts()     # >= E; padded experts get no tokens
    C = _capacity(T, k, E, spec.capacity_factor)

    if hasattr(x, "device_mesh"):
        out = _routed_on_mesh(x, p, spec, act, C)
    else:
        xf = x.reshape(T, d)
        gates, experts = route(xf, p["router"], spec)
        pos, keep = dispatch(experts, E, C)
        out = _expert_sums(xf, gates, experts, pos, keep, p["w_in"],
                           p.get("w_gate"), p["w_out"], act, (0, E_buf),
                           (0, C)).view(B, S, d)

    if "shared_w_in" in p:
        shared = mlp(x, {"w_in": p["shared_w_in"],
                         "w_gate": p["shared_w_gate"],
                         "w_out": p["shared_w_out"]}, act)
        return out + torch.sigmoid(x @ p["shared_gate"].to(x.dtype)) * shared
    return out


def _block(placements, dim: int, size: int, mesh) -> tuple[int, int]:
    """(first, count) of this process's slice of dimension ``dim`` (of
    ``size``) under ``placements`` on ``mesh``: the mesh axes that shard
    it, outer first, as DTensor splits it."""
    index, parts = 0, 1
    for axis, pl in zip(mesh.axis_names, placements):
        if pl.is_shard(dim):
            index = index * mesh.shape[axis] + \
                mesh.device_mesh.get_local_rank(axis)
            parts *= mesh.shape[axis]
    return index * (size // parts), size // parts


def _routed_on_mesh(x, p: dict, spec, act: str, C: int) -> torch.Tensor:
    """The routed experts of :func:`moe_ffn` for a DTensor x (B, S, d),
    returned at x's rows over the batch axes, whole on the others.

    Each process routes its rows (``route``, the router gathered whole);
    the routings are gathered over the batch axes in token order and
    ``dispatch`` ranks them there, the same on every process.  The buffer
    (E_buf, C, d) is placed by the reference's ``("experts", "batch",
    None)`` and the hidden by ``("experts", "batch", "expert_mlp")``:
    each process fills and runs its block of it (:func:`_expert_sums`)
    from the tokens and gates gathered whole and the weights at that
    block's placements, and its partial sums are reduced over the mesh
    axes that split the block (a Partial output: reduce-scatter over the
    data axes, all-reduce over ``model``).  The gradients of what a
    process reads whole are partial sums likewise: ``local_map`` is told
    so, and reduces them onto their shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.mesh import as_mesh
    from repro_torch.parallel.sharding import mesh_placements
    mesh = as_mesh(x.device_mesh)
    dm = mesh.device_mesh
    B, S, d = x.shape
    E, E_buf = spec.num_experts, spec.padded_experts()
    fe = p["w_in"].shape[-1]
    whole = [Replicate()] * len(mesh.axis_names)
    by_rows = mesh_placements(x.shape, ("batch", None, None), mesh)
    partial_rows = [Partial() if pl.is_shard() else pl for pl in by_rows]

    gates, experts = local_map(
        lambda x_, r_: route(x_.reshape(-1, d), r_, spec),
        out_placements=(by_rows, by_rows), in_placements=(by_rows, whole),
        in_grad_placements=(by_rows, partial_rows), device_mesh=dm,
        redistribute_inputs=True)(x, p["router"])
    experts = experts.redistribute(dm, whole).to_local()   # token order
    pos, keep = dispatch(experts, E, C)

    pbuf = mesh_placements((E_buf, C, d), ("experts", "batch", None), mesh)
    ph = mesh_placements((E_buf, C, fe), ("experts", "batch",
                                          "expert_mlp"), mesh)
    rows, cols = _block(pbuf, 0, E_buf, mesh), _block(pbuf, 1, C, mesh)
    split = [a.is_shard() or b.is_shard() for a, b in zip(pbuf, ph)]

    def weight(mlp_dim):
        """A weight's placements (experts on dim 0, the expert hidden on
        ``mlp_dim``) for the block, and its gradient's: partial over the
        axes that split only the capacity."""
        pl = [Shard(0) if b.is_shard(0) else Shard(mlp_dim) if h.is_shard(2)
              else Replicate() for b, h in zip(pbuf, ph)]
        grad = [Partial() if b.is_shard(1) else q for b, q in zip(pbuf, pl)]
        return pl, grad
    w_up, w_down = weight(2), weight(1)
    partial = [Partial() if s else Replicate() for s in split]

    def block(x_, g_, w_in, w_gate, w_out):
        return _expert_sums(x_.reshape(-1, d), g_, experts, pos, keep, w_in,
                            w_gate, w_out, act, rows, cols).view(x_.shape)
    w_gate = p.get("w_gate")
    out = local_map(
        block, out_placements=partial,
        in_placements=(whole, whole, w_up[0],
                       None if w_gate is None else w_up[0], w_down[0]),
        in_grad_placements=(partial, partial, w_up[1],
                            None if w_gate is None else w_up[1], w_down[1]),
        device_mesh=dm, redistribute_inputs=True)(
        x, gates, p["w_in"], w_gate, p["w_out"])
    return out.redistribute(dm, by_rows)
