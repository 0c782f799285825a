"""Mamba2 (SSD, state-space duality) blocks.

The port's twin of ``repro.models.ssm``: three forms of the recurrence
    h_t = exp(dt_t A) h_{t-1} + dt_t * (B_t ⊗ x_t),   y_t = C_t · h_t + D x_t
  * ``ssd_chunked``    — prefill: intra-chunk quadratic form plus a scan
                         over the chunk states;
  * ``ssd_recurrent``  — decode: one state update a token;
  * ``ssd_sequential`` — the step-by-step oracle the tests hold them to.

Shapes: x (B,S,nh,hp), dt (B,S,nh), A (nh,), B/C (B,S,ng,ds), D (nh,).
Head h reads B/C group h // (nh // ng).

The reference writes ``ssd_chunked``'s contractions as four-operand
einsums; here the elementwise factors are folded first and each
contraction is one batched product over (batch, chunk, head), so the
largest intermediate is (B, nc, nh, cl, cl) in fp32 (a pairwise einsum
path could build a (B, nc, cl, cl, nh, hp) tensor: ~21 GB at Mamba2-2.7B's
prefill of 4 x 2048).

A difference by design: ``ssd_chunked`` builds the intra-chunk decay as
``exp(where(tril, cum_i - cum_j, -inf))`` where the reference writes
``where(tril, exp(cum_i - cum_j), 0)``.  The forward is the same number
for number; at the published chunk of 128 the reference's form overflows
``exp`` above the diagonal and its gradient is NaN, while this one's is
finite and equals ``ssd_sequential``'s autograd.  Every other ``exp`` here
takes a value <= 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _expand_groups(bc: torch.Tensor, nh: int) -> torch.Tensor:
    """(B, S, ng, ds) -> (B, S, nh, ds) by repeating groups."""
    return torch.repeat_interleave(bc, nh // bc.shape[2], dim=2)


def ssd_sequential(x, dt, A, B, C, D, *, h0=None):
    """Oracle: the step-by-step recurrence in fp32.  Returns (y in x's
    dtype, final state (B, nh, hp, ds) fp32)."""
    Bt, S, nh, hp = x.shape
    ds = B.shape[-1]
    Bh, Ch = _expand_groups(B, nh).float(), _expand_groups(C, nh).float()
    xf, dtf = x.float(), dt.float()
    h = (torch.zeros((Bt, nh, hp, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A)[..., None, None]
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        h = h * decay + upd
        ys.append(torch.einsum("bhps,bhs->bhp", h, Ch[:, t])
                  + D[None, :, None] * xf[:, t])
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_recurrent(h, x_t, dt_t, A, B_t, C_t, D):
    """One decode step.  h (B,nh,hp,ds) fp32; x_t (B,nh,hp); dt_t (B,nh);
    B_t/C_t (B,ng,ds).  Returns (y_t in x_t's dtype, h_new)."""
    nh = x_t.shape[1]
    b = _expand_groups(B_t[:, None], nh)[:, 0].float()
    c = _expand_groups(C_t[:, None], nh)[:, 0].float()
    decay = torch.exp(dt_t.float() * A)[..., None, None]
    upd = (dt_t[..., None] * x_t).float()[..., None] * b[:, :, None, :]
    h = h * decay + upd
    y = torch.einsum("bhps,bhs->bhp", h, c) + D[None, :, None] * x_t.float()
    return y.to(x_t.dtype), h


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 128, h0=None):
    """Chunked SSD.  Returns (y in x's dtype, final state fp32).
    S % chunk == 0 (callers pad)."""
    Bt, S, nh, hp = x.shape
    ng, ds = B.shape[2], B.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S = {S} is not a multiple of the "
                         f"chunk {chunk}")
    nc, cl = S // chunk, chunk
    f32 = torch.float32
    # (b, n, h, i, ...) layouts: each contraction below is one batched
    # product over (b, n, h)
    xr = x.reshape(Bt, nc, cl, nh, hp).to(f32).permute(0, 1, 3, 2, 4)
    dtr = dt.reshape(Bt, nc, cl, nh).to(f32).permute(0, 1, 3, 2)  # b,n,h,i
    Bg = B.reshape(Bt, nc, cl, ng, ds).to(f32).permute(0, 1, 3, 2, 4)
    Cg = C.reshape(Bt, nc, cl, ng, ds).to(f32).permute(0, 1, 3, 2, 4)
    heads = torch.arange(nh, device=x.device) // (nh // ng)
    Br, Cr = Bg[:, :, heads], Cg[:, :, heads]                  # b,n,h,i,s

    cum = torch.cumsum(dtr * A[:, None], dim=-1)               # inclusive
    # decay from position j (exclusive) to i (inclusive), i >= j
    # masked before the exp: above the diagonal cum_i - cum_j is a positive
    # sum that overflows exp at the published chunk of 128, and where()'s
    # backward multiplies its zero by that inf (NaN); exp(-inf) is exactly
    # the 0 the reference writes there, so the forward is unchanged
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                              -torch.inf))                     # b,n,h,i,j

    # intra-chunk: y[i] += C_i . sum_{j<=i} L_ij dt_j (B_j ⊗ x_j); C_i . B_j
    # is a group's, shared by its heads
    cb = (Cg @ Bg.transpose(-1, -2))[:, :, heads]              # b,n,h,i,j
    y_diag = (cb * L * dtr[..., None, :]) @ xr                 # b,n,h,i,p

    # chunk states: chunk c's contribution to the state at its end
    decay_to_end = torch.exp(cum[..., -1:] - cum)              # b,n,h,j
    states = ((xr * (decay_to_end * dtr)[..., None]).transpose(-1, -2)
              @ Br)                                            # b,n,h,p,s

    # inter-chunk recurrence: a scan over the nc chunks
    chunk_decay = torch.exp(cum[..., -1])                      # b,n,h
    h = (torch.zeros((Bt, nh, hp, ds), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                       # b,n,h,p,s

    # off-diagonal: y[i] += C_i . (h_prev decayed to i)
    y_off = (Cr * torch.exp(cum)[..., None]) @ h_prev.transpose(-1, -2)

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(Bt, S, nh, hp)
    y = y + D[None, None, :, None] * x.to(f32)
    return y.to(x.dtype), h


# ------------------------------------------------------------ full block ops
def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv1d in fp32.  x (B, S, C), w (K, C), b (C,)."""
    K, Cdim = w.shape
    xp = F.pad(x.float().transpose(1, 2), (K - 1, 0))         # (B, C, S+K-1)
    out = F.conv1d(xp, w.float().t()[:, None, :], b.float(), groups=Cdim)
    return out.transpose(1, 2).to(x.dtype)


def conv_step(conv_state: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the causal conv.  conv_state (B, K-1, C),
    x_t (B, C).  Returns (y_t (B, C), new_state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # (B, K, C)
    y = (window.float() * w.float()[None]).sum(dim=1) + b.float()
    return y.to(x_t.dtype), window[:, 1:]


def mamba2_mix(p: dict, x: torch.Tensor, cfg, *, mode: str,
               state: dict | None = None):
    """The Mamba2 mixer (in place of attention).  x (B, S, d).

    mode: "full" (prefill; returns (y, new_state)) or "step" (decode;
    S == 1, needs ``state``).  state = {"conv": (B, K-1, conv_dim),
    "ssm": (B, nh, hp, ds) fp32}; the new conv state holds the last K-1
    pre-activation xBC inputs.  A DTensor x (a device mesh) runs
    :func:`_mix_on_mesh`."""
    if hasattr(x, "device_mesh"):
        return _mix_on_mesh(p, x, cfg, mode=mode, state=state)
    step = mode == "step"
    y, conv, h = _mix(x, p, cfg, step=step,
                      conv_state=state["conv"] if step else None,
                      ssm_state=state["ssm"] if state is not None else None)
    return y, {"conv": conv, "ssm": h}


def _mix(x, p: dict, cfg, *, step: bool, conv_state, ssm_state,
         blocks: tuple | None = None, dm=None):
    """The mixer's body on one process: x (B, S, d) and ``p`` the weights
    it holds.  ``blocks``: the slices (first, count, mesh axis) of d_proj,
    conv_dim, the SSM heads, their B/C groups and d_inner that it holds
    (whole without them: the one-device mixer); ``dm``, the device mesh
    whose axes gather and reduce them.  Returns (y, the new conv state, the
    new SSM state) of its slices."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    ds, ng, hp, K = s.d_state, s.n_groups, s.head_dim, s.conv_width
    conv_dim = d_inner + 2 * ng * ds
    proj_b, conv_b, heads_b, groups_b, inner_b = blocks or (
        (0, d_inner + conv_dim + nh, None), (0, conv_dim, None),
        (0, nh, None), (0, ng, None), (0, d_inner, None))
    B_, S_, _ = x.shape
    hn = heads_b[1]

    def gather(t, block):
        if block[2] is None:
            return t
        return _Gather.apply(t, t.dim() - 1, dm.get_group(block[2]),
                             dm.get_local_rank(block[2]))

    proj = gather(x @ p["in_proj"].to(x.dtype), proj_b)
    z, xbc_pre, dt_raw = proj.split([d_inner, conv_dim, nh], dim=-1)
    xbc_mine = _take(xbc_pre, -1, conv_b)
    if step:
        conv_out, conv_new = conv_step(conv_state, xbc_mine[:, 0],
                                       p["conv_w"], p["conv_b"])
        xbc = gather(F.silu(conv_out), conv_b)[:, None]
    else:
        xbc = gather(F.silu(causal_conv(xbc_mine, p["conv_w"], p["conv_b"])),
                     conv_b)

    xs, Bc, Cc = xbc.split([d_inner, ng * ds, ng * ds], dim=-1)
    xs = _take(xs.reshape(B_, S_, nh, hp), 2, heads_b)
    Bc = _take(Bc.reshape(B_, S_, ng, ds), 2, groups_b)
    Cc = _take(Cc.reshape(B_, S_, ng, ds), 2, groups_b)
    dt = F.softplus(_take(dt_raw, -1, heads_b).float()
                    + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()

    if step:
        y, h = ssd_recurrent(ssm_state, xs[:, 0], dt[:, 0], A, Bc[:, 0],
                             Cc[:, 0], D)
        y = y[:, None]
    else:
        # padded after the softplus: padded steps have dt = 0 and leave the
        # state alone
        pad = -S_ % s.chunk
        if pad:
            xs, Bc, Cc = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, Bc, Cc))
            dt = F.pad(dt, (0, 0, 0, pad))
        y, h = ssd_chunked(xs, dt, A, Bc, Cc, D, chunk=s.chunk, h0=ssm_state)
        y = y[:, :S_]
        conv_new = (xbc_mine[:, S_ - (K - 1):] if S_ >= K - 1
                    else F.pad(xbc_mine, (0, 0, K - 1 - S_, 0)))

    # gated RMSNorm on the channels held (the mean over the whole d_inner:
    # where they are split, their sum of squares reduced), then their rows
    # of the output projection (where split, partial sums)
    y = y.reshape(B_, S_, hn * hp)
    if hn == nh:
        y = _take(y, -1, inner_b)
    y = y * F.silu(_take(z, -1, inner_b).float()).to(y.dtype)
    yf = y.float()
    if inner_b[2] is None:
        var = torch.mean(yf * yf, dim=-1, keepdim=True)
    else:
        var = _AllReduce.apply((yf * yf).sum(dim=-1, keepdim=True),
                               dm.get_group(inner_b[2])) / d_inner
    y = (yf * torch.rsqrt(var + cfg.norm_eps)
         * (1.0 + p["norm"].float())).to(y.dtype)
    return y @ p["out_proj"].to(x.dtype), conv_new, h


# ------------------------------------------------------------ device mesh
#: the logical names of one layer's conv and state caches (the reference's
#: ``cache_logical`` without the layer axis): the placements the mesh route
#: returns the new states at
CONV_LOGICAL = ("batch", None, "mlp")
STATE_LOGICAL = ("batch", "heads", None, "state")


def _block_of(placements, dim: int, size: int, mesh) -> tuple:
    """(first, count, axis) of this process's slice of dimension ``dim``
    (of ``size``) under ``placements``: the one mesh axis of more than one
    device that splits it (None, the whole dimension, if none does)."""
    axes = [a for a, pl in zip(mesh.axis_names, placements)
            if pl.is_shard(dim) and mesh.shape[a] > 1]
    if not axes:
        return 0, size, None
    if len(axes) > 1:
        raise NotImplementedError(f"a dimension split over {axes}: the "
                                  f"Mamba2 mixer splits over one axis")
    n = mesh.shape[axes[0]]
    return mesh.device_mesh.get_local_rank(axes[0]) * (size // n), \
        size // n, axes[0]


def _take(t, dim: int, block: tuple):
    """``t``'s slice ``block`` (first, count, ...) of dimension ``dim``;
    ``t`` itself when that is all of it."""
    first, count = block[:2]
    return t if count == t.shape[dim] else t.narrow(dim, first, count)


class _Gather(torch.autograd.Function):
    """Each process's slice of dimension ``dim`` gathered whole over
    ``group`` (in rank order); the backward sums the whole gradient over
    the group (every process's is a partial sum) and keeps its slice."""

    @staticmethod
    def forward(ctx, t, dim, group, index):
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        ctx.dim, ctx.group, ctx.first = dim, group, index * t.shape[dim]
        ctx.count = t.shape[dim]
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.first, ctx.count), None, None, None


class _AllReduce(torch.autograd.Function):
    """The sum over ``group``; its backward is the sum of the gradients."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _mix_on_mesh(p: dict, x, cfg, *, mode: str, state: dict | None):
    """:func:`mamba2_mix` of a DTensor x (B, S, d) on its device mesh, the
    parameters and states at the reference's placements (``in_proj``'s
    columns and ``conv_w``/``conv_b``/``norm``/``out_proj``'s rows on
    ``mlp``, ``dt_bias``/``A_log``/``D`` and the state on ``heads``, the
    conv cache on ``mlp``; each over ``model`` where it divides), in one
    ``local_map`` with explicit collectives.  Each process, on its rows of
    the batch:

    * multiplies x by its columns of ``in_proj`` (its FSDP shard gathered
      over ``data``) and gathers the projection whole over ``model``;
    * runs the causal conv on its channels (the conv cache's shard: decode
      reads and writes only its own) and gathers the conv's output whole;
    * runs the SSD (chunked, or a recurrent step) on its SSM heads and
      their state, where ``model`` divides the heads, else on every head;
    * keeps its channels of ``d_inner`` (``out_proj``'s rows), gates them
      by ``z``, and takes the norm's mean over the whole ``d_inner`` as its
      sum of squares all-reduced over ``model`` where they are split;
    * multiplies by its rows of ``out_proj``: partial sums, all-reduced.

    The body is :func:`_mix`, the one-device mixer's, on these slices.
    The output and the gradients are partial sums over the axis that splits
    ``d_inner`` (``in_grad_placements``; the gathers' backward sums them)
    and over those that split the batch; on any other axis every process
    computes alike, and they are whole there.  Returns (y at x's rows,
    whole over the other axes; the new conv and SSM states at
    ``CONV_LOGICAL``/``STATE_LOGICAL``'s placements).  On a mesh of one
    device every slice is whole and no collective runs: the one-device
    computation, op for op."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.launch.mesh import as_mesh
    from repro_torch.parallel.sharding import mesh_placements
    mesh = as_mesh(x.device_mesh)
    dm = mesh.device_mesh
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    ds, ng, hp, K = s.d_state, s.n_groups, s.head_dim, s.conv_width
    conv_dim = d_inner + 2 * ng * ds
    d_proj = d_inner + conv_dim + nh
    B_, S_, _ = x.shape
    step = mode == "step"

    by_rows = mesh_placements(x.shape, ("batch", None, None), mesh)
    conv_pl = mesh_placements((B_, K - 1, conv_dim), CONV_LOGICAL, mesh)
    state_pl = mesh_placements((B_, nh, hp, ds), STATE_LOGICAL, mesh)

    def own(t, dim):
        """A parameter's placements with only its split of ``dim`` kept
        (its FSDP shard gathered)."""
        return [pl if pl.is_shard(dim) else Replicate()
                for pl in t.placements]
    dims = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "dt_bias": 0,
            "A_log": 0, "D": 0, "norm": 0, "out_proj": 0}
    names = list(dims)
    pl = {n: own(p[n], dims[n]) for n in names}
    proj_b = _block_of(pl["in_proj"], 1, d_proj, mesh)
    conv_b = _block_of(pl["conv_w"], 1, conv_dim, mesh)
    heads_b = _block_of(pl["dt_bias"], 0, nh, mesh)
    inner_b = _block_of(pl["out_proj"], 0, d_inner, mesh)
    if (conv_b[:2] != _block_of(conv_pl, 2, conv_dim, mesh)[:2]
            or heads_b[:2] != _block_of(state_pl, 1, nh, mesh)[:2]
            or {b[2] for b in (proj_b, conv_b, heads_b)} - {None,
                                                             inner_b[2]}):
        raise NotImplementedError("the Mamba2 mixer's weights and caches "
                                  "split on different axes, or on one that "
                                  "leaves d_inner whole")
    # the axis that splits d_inner (inner_b's) is the one the mixer's
    # slices are gathered and its partial sums reduced over; on an axis
    # that splits neither it nor the batch every process computes alike
    rows_split = [q.is_shard() for q in by_rows]

    def grad_of(placements):
        """A weight's gradient: its split kept; partial over the axes that
        split the batch and over d_inner's; whole on the others."""
        return [q if q.is_shard() else Partial() if split or (
            a == inner_b[2]) else q for a, q, split in zip(
                mesh.axis_names, placements, rows_split)]

    # the groups of the heads each process runs: whole groups, or a slice
    # of one
    per_group = nh // ng
    h0, hn = heads_b[:2]
    if hn != nh and not (hn % per_group == 0 or per_group % hn == 0):
        raise NotImplementedError(f"{hn} SSM heads a process straddle the "
                                  f"{ng} groups of {per_group} heads")
    blocks = (proj_b, conv_b, heads_b, (h0 // per_group,
                                        max(hn // per_group, 1)), inner_b)

    def local(x_, *args):
        *weights, conv_state, ssm_state = args
        return _mix(x_, dict(zip(names, weights)), cfg, step=step,
                    conv_state=conv_state, ssm_state=ssm_state,
                    blocks=blocks, dm=dm)

    states = (state["conv"] if step else None,
              state["ssm"] if state is not None else None)
    state_in = tuple(None if t is None else q
                     for t, q in zip(states, (conv_pl, state_pl)))
    out_pl = [Partial() if a == inner_b[2] else q
              for a, q in zip(mesh.axis_names, by_rows)]
    out, conv_new, h = local_map(
        local, out_placements=(out_pl, conv_pl, state_pl),
        in_placements=(by_rows, *(pl[n] for n in names), *state_in),
        in_grad_placements=(out_pl, *(grad_of(pl[n]) for n in names),
                            *state_in),
        device_mesh=dm, redistribute_inputs=True)(
        x, *(p[n] for n in names), *states)
    return out.redistribute(dm, by_rows), {"conv": conv_new, "ssm": h}
