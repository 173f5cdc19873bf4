"""Mamba2 / SSD (state-space duality) layer — chunked parallel form for
prefill, recurrent form for decode (Dao & Gu, arXiv:2405.21060), from the
JAX package's `repro/models/ssm.py`.

Recurrence (per head h, head dim P, state dim N, B/C shared across heads):
    S_t = exp(dt_t * A) * S_{t-1} + dt_t * (B_t  (x) x_t)      S: (N, P)
    y_t = C_t @ S_t + D * x_t

The chunked form computes intra-chunk contributions with a causal decay
matrix (segment-sum) and carries inter-chunk states with a loop over chunks
(the reference's `lax.scan`).  `mamba2_block(..., kernels=True)` runs the
prefill scan through the CUDA kernel (`repro_torch.kernels.ssd_scan`) and
the gated norm through the rmsnorm kernel; decode stays plain torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import rmsnorm
from repro_torch.models.module import ParamSpec

F32 = torch.float32


def segsum(a):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} a[..., k] (j < i)."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int = 64, initial_state=None):
    """x: (B,S,H,P); dt: (B,S,H) >0; A: (H,) <0; Bm, Cm: (B,S,N).

    Returns y: (B,S,H,P) and final state (B,H,P,N).
    """
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nc = S // L
    assert nc * L == S, (S, L)

    a = (dt * A[None, None, :]).float()                     # (B,S,H) negative
    xd = (x * dt[..., None]).float()
    a_c = a.reshape(Bsz, nc, L, H)
    x_c = xd.reshape(Bsz, nc, L, H, Pd)
    B_c = Bm.reshape(Bsz, nc, L, N).float()
    C_c = Cm.reshape(Bsz, nc, L, N).float()

    # ---- intra-chunk (diagonal blocks) --------------------------------------
    Lmat = torch.exp(segsum(torch.movedim(a_c, 3, 2)))      # (B,nc,H,L,L)
    Y_diag = torch.einsum("bcln,bcsn,bchls,bcshp->bclhp",
                          C_c, B_c, Lmat, x_c)

    # ---- chunk-boundary states ----------------------------------------------
    cum = torch.cumsum(a_c, dim=2)                          # (B,nc,L,H)
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,L,H)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", B_c, decay_states, x_c)

    # ---- inter-chunk recurrence over chunk states ----------------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B,nc,H)
    s = (x.new_zeros((Bsz, H, Pd, N), dtype=F32) if initial_state is None
         else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(s)                                      # state BEFORE chunk
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    state_decay = torch.exp(cum)                            # (B,nc,L,H)
    Y_off = torch.einsum("bcln,bchpn,bclh->bclhp", C_c, prev_states,
                         state_decay)

    y = (Y_diag + Y_off).reshape(Bsz, S, H, Pd)
    return y.to(x.dtype), s


def ssd_scan_oracle(x, dt, A, Bm, Cm, initial_state=None):
    """Pure per-token recurrence (test oracle)."""
    Bsz, S, H, Pd = x.shape
    N = Bm.shape[-1]
    s = (x.new_zeros((Bsz, H, Pd, N), dtype=F32) if initial_state is None
         else initial_state.float())
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    ys = []
    for t in range(S):
        dec = torch.exp(dtf[:, t] * A)                      # (B,H)
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           bf[:, t])
        s = s * dec[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), s


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token recurrent update. x: (B,1,H,P); returns (y, new_state)."""
    xt, dtt = x[:, 0].float(), dt[:, 0].float()
    bt, ct = Bm[:, 0].float(), Cm[:, 0].float()
    dec = torch.exp(dtt * A)
    upd = torch.einsum("bhp,bn->bhpn", xt * dtt[..., None], bt)
    s = state * dec[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", s, ct)
    return y[:, None].to(x.dtype), s


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj -> causal conv1d -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

CONV_W = 4  # causal short conv width


def mamba2_specs(d_model: int, d_state: int = 64, headdim: int = 64,
                 expand: int = 2, dtype=torch.bfloat16):
    d_inner = expand * d_model
    H = d_inner // headdim
    d_conv = d_inner + 2 * d_state   # conv over [x, B, C]
    return {
        "in_proj": ParamSpec((d_model, 2 * d_inner + 2 * d_state + H), dtype,
                             ("embed", "mlp")),
        "conv_w": ParamSpec((CONV_W, d_conv), dtype, (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((d_conv,), dtype, (None,), init="zeros"),
        "A_log": ParamSpec((H,), torch.float32, (None,), init="zeros"),
        "D": ParamSpec((H,), torch.float32, (None,), init="ones"),
        "dt_bias": ParamSpec((H,), torch.float32, (None,), init="zeros"),
        "norm": ParamSpec((d_inner,), dtype, (None,), init="ones"),
        "out_proj": ParamSpec((d_inner, d_model), dtype, ("mlp", "embed")),
    }


def _split_inproj(z_all, d_inner, d_state, H):
    z, xbc, dt = torch.split(
        z_all, [d_inner, d_inner + 2 * d_state, H], dim=-1)
    return z, xbc, dt


def mamba2_block(params, x, *, d_state: int = 64, headdim: int = 64,
                 chunk: int = 64, state=None, conv_state=None,
                 kernels: bool = False):
    """x: (B,S,D). state/conv_state given => carried in (decode, or a
    prefill that starts from the cache's state, as the reference's does).

    Returns (y, (ssm_state, conv_state))."""
    B, S, D = x.shape
    d_inner = params["out_proj"].shape[0]
    H = d_inner // headdim

    z_all = x @ params["in_proj"]
    z, xbc, dt_raw = _split_inproj(z_all, d_inner, d_state, H)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])           # (B,S,H)

    # causal conv over [x, B, C] streams
    if conv_state is None:
        pad = xbc.new_zeros((B, CONV_W - 1, xbc.shape[-1]))
    else:
        pad = conv_state.to(xbc.dtype)
    xbc_pad = torch.cat([pad, xbc], dim=1)
    new_conv_state = xbc_pad[:, -(CONV_W - 1):, :]
    conv = sum(xbc_pad[:, i:i + S, :] * params["conv_w"][i][None, None, :]
               for i in range(CONV_W)) + params["conv_b"]
    conv = F.silu(conv)

    xs, Bm, Cm = torch.split(conv, [d_inner, d_state, d_state], dim=-1)
    xh = xs.reshape(B, S, H, headdim)
    A = -torch.exp(params["A_log"])                                # (H,) < 0

    if S > 1:  # prefill (chunked parallel form)
        if kernels:
            y, s_final = ssd_scan(xh, dt, A, Bm, Cm, chunk=chunk,
                                  initial_state=state)
        else:
            y, s_final = ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk,
                                     initial_state=state)
    else:      # decode (recurrent form)
        s0 = state if state is not None else x.new_zeros(
            (B, H, headdim, d_state), dtype=F32)
        y, s_final = ssd_decode_step(s0, xh, dt, A, Bm, Cm)
    y = y + params["D"][None, None, :, None].float() * xh.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)

    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), params["norm"],
                kernels=kernels)
    return y @ params["out_proj"], (s_final, new_conv_state)
