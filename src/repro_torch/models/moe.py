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


def moe_ffn(x: torch.Tensor, p: dict, spec, act: str = "silu"
            ) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d).  p: router (d, E); experts w_gate/w_in
    (E_buf, d, fe), w_out (E_buf, fe, d); optional shared_* for the shared
    experts (w_gate/w_in (d, fs), w_out (fs, d), gate (d, 1))."""
    B, S, d = x.shape
    T = B * S
    E, k = spec.num_experts, spec.top_k
    E_buf = spec.padded_experts()     # >= E; padded experts get no tokens
    C = _capacity(T, k, E, spec.capacity_factor)
    dt = x.dtype

    xf = x.reshape(T, d)
    gates, experts = route(xf, p["router"], spec)
    pos, keep = dispatch(experts, E, C)
    # the buffer's last row takes the dropped assignments and is cut off
    slot = torch.where(keep, experts.reshape(-1) * C + pos, E_buf * C)
    buf = torch.zeros((E_buf * C + 1, d), dtype=dt, device=x.device)
    buf[slot] = xf[:, None].expand(T, k, d).reshape(T * k, d)
    buf = buf[:-1].view(E_buf, C, d)

    h = torch.bmm(buf, p["w_in"].to(dt))
    if act in ("silu", "geglu"):
        g = torch.bmm(buf, p["w_gate"].to(dt))
        g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
        h = g * h
    else:
        h = F.gelu(h, approximate="tanh")
    y_buf = torch.bmm(h, p["w_out"].to(dt)).view(E_buf * C, d)

    # gather back with gate weights (dropped assignments contribute 0)
    contrib = y_buf[slot.clamp(max=E_buf * C - 1)] * (
        gates.reshape(-1) * keep).to(dt)[:, None]
    out = contrib.view(T, k, d).sum(dim=1).view(B, S, d)

    if "shared_w_in" in p:
        shared = mlp(x, {"w_in": p["shared_w_in"],
                         "w_gate": p["shared_w_gate"],
                         "w_out": p["shared_w_out"]}, act)
        return out + torch.sigmoid(x @ p["shared_gate"].to(dt)) * shared
    return out
