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
    tri = torch.ones((cl, cl), dtype=torch.bool, device=x.device).tril()
    L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    0.0)                                       # b,n,h,i,j

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
    pre-activation xBC inputs."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    ds, ng = s.d_state, s.n_groups
    conv_dim = d_inner + 2 * ng * ds
    B_, S_, _ = x.shape

    proj = x @ p["in_proj"].to(x.dtype)
    z, xbc_pre, dt_raw = proj.split([d_inner, conv_dim, nh], dim=-1)

    if mode == "step":
        conv_out, conv_state = conv_step(state["conv"], xbc_pre[:, 0],
                                         p["conv_w"], p["conv_b"])
        xbc = F.silu(conv_out)[:, None]
    else:
        xbc = F.silu(causal_conv(xbc_pre, p["conv_w"], p["conv_b"]))

    xs, Bc, Cc = xbc.split([d_inner, ng * ds, ng * ds], dim=-1)
    xs = xs.reshape(B_, S_, nh, s.head_dim)
    Bc = Bc.reshape(B_, S_, ng, ds)
    Cc = Cc.reshape(B_, S_, ng, ds)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()

    if mode == "step":
        y, h = ssd_recurrent(state["ssm"], xs[:, 0], dt[:, 0], A, Bc[:, 0],
                             Cc[:, 0], D)
        y = y[:, None]
        new_state = {"conv": conv_state, "ssm": h}
    else:
        # padded after the softplus: padded steps have dt = 0 and leave the
        # state alone
        pad = -S_ % s.chunk
        if pad:
            xs, Bc, Cc = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, Bc, Cc))
            dt = F.pad(dt, (0, 0, 0, pad))
        h0 = state["ssm"] if state is not None else None
        y, h = ssd_chunked(xs, dt, A, Bc, Cc, D, chunk=s.chunk, h0=h0)
        y = y[:, :S_]
        K = s.conv_width
        tail = (xbc_pre[:, S_ - (K - 1):] if S_ >= K - 1
                else F.pad(xbc_pre, (0, 0, K - 1 - S_, 0)))
        new_state = {"conv": tail, "ssm": h}

    # gated RMSNorm, then the output projection
    y = y.reshape(B_, S_, d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    y = (yf * torch.rsqrt(var + cfg.norm_eps)
         * (1.0 + p["norm"].float())).to(y.dtype)
    return y @ p["out_proj"].to(x.dtype), new_state
