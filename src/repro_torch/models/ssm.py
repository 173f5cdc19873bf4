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

`mamba2_block(tp=)` runs the block on this rank's SSD heads of `tp`'s
"model" ranks.  `in_proj` and `conv_w` come whole: their
stored blocks split the fused columns [z | x | B | C | dt] (and the conv's
[x | B | C]) where no head boundary falls, so the rank takes the z, x and
dt of its heads and B and C whole (`local_spans`, every rank computing the
same B and C); `out_proj` holds this rank's rows (the layout's block is
head-aligned), the gated norm runs over the split row (`rmsnorm_split`,
plain math), x enters through `copy_to` and the output sums over "model"
(`reduce_from`).  The cache keeps every head and conv channel; a rank
reads and writes its own (`local_cache`, `store_local`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.layers import rmsnorm, rmsnorm_split
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.collectives import copy_to, reduce_from, rows

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


def local_spans(d_inner: int, d_state: int, headdim: int, tp):
    """(the spans of `in_proj`'s columns, the spans of the conv channels)
    this rank's heads of `tp`'s "model" ranks use: z, x, B, C, dt of
    [z | x | B | C | dt], and x, B, C of [x | B | C].

        >>> from repro_torch.sharding.rules import Mesh
        >>> local_spans(256, 16, 32, Mesh.abstract((1, 4), ("d", "model")))
        ([(0, 64), (256, 320), (512, 544), (544, 546)], [(0, 64), (256, 288)])
    """
    n = d_inner // headdim // tp.size("model")
    h0 = tp.index("model") * n
    c0, c1 = h0 * headdim, (h0 + n) * headdim
    bc = 2 * d_inner + 2 * d_state
    return ([(c0, c1), (d_inner + c0, d_inner + c1), (2 * d_inner, bc),
             (bc + h0, bc + h0 + n)],
            [(c0, c1), (d_inner, d_inner + 2 * d_state)])


def _cols(w, spans):
    """The columns `spans` of `w`'s last axis, laid side by side."""
    return torch.cat([w[..., a:b] for a, b in spans], dim=-1)


def local_cache(cache, d_state: int, headdim: int, tp):
    """(views of this rank's heads of a layer's float32 state and of its
    conv channels, the state and conv carry as `mamba2_block` takes
    them: contiguous copies under `tp`, the cache's tensors without)."""
    if tp is None:
        return (cache["state"], [cache["conv"]]), (cache["state"],
                                                   cache["conv"])
    d_inner = cache["conv"].shape[-1] - 2 * d_state
    views = (rows(cache["state"], tp, "model", 1),
             [cache["conv"][..., a:b] for a, b in
              local_spans(d_inner, d_state, headdim, tp)[1]])
    return views, (views[0].contiguous(), torch.cat(views[1], dim=-1))


def store_local(views, state, conv) -> None:
    """Write a block's new state and conv carry into `local_cache`'s
    views, in place."""
    views[0].copy_(state)
    at = 0
    for v in views[1]:
        v.copy_(conv[..., at:at + v.shape[-1]])
        at += v.shape[-1]


def mamba2_block(params, x, *, d_state: int = 64, headdim: int = 64,
                 chunk: int = 64, state=None, conv_state=None, tp=None,
                 kernels: bool = False):
    """x: (B,S,D). state/conv_state given => carried in (decode, or a
    prefill that starts from the cache's state, as the reference's does).
    `tp`: this rank's heads of its "model" ranks (module docstring);
    state and conv_state then hold this rank's heads and conv channels.

    Returns (y, (ssm_state, conv_state))."""
    B, S, D = x.shape
    d_inner = params["norm"].shape[0]
    H = d_inner // headdim
    in_proj, conv_w, conv_b = (params[k] for k in ("in_proj", "conv_w",
                                                   "conv_b"))
    A_log, Dskip, dt_bias, norm = (params[k] for k in ("A_log", "D",
                                                       "dt_bias", "norm"))
    if tp is not None:
        x = copy_to(x, tp, "model")
        proj, conv = local_spans(d_inner, d_state, headdim, tp)
        in_proj, conv_w, conv_b = (_cols(in_proj, proj), _cols(conv_w, conv),
                                   _cols(conv_b, conv))
        A_log, Dskip, dt_bias, norm = (rows(p, tp, "model") for p in (
            A_log, Dskip, dt_bias, norm))
        H, d_inner = A_log.shape[0], norm.shape[0]

    z_all = x @ in_proj
    z, xbc, dt_raw = _split_inproj(z_all, d_inner, d_state, H)
    dt = F.softplus(dt_raw.float() + dt_bias)                     # (B,S,H)

    # causal conv over [x, B, C] streams
    if conv_state is None:
        pad = xbc.new_zeros((B, CONV_W - 1, xbc.shape[-1]))
    else:
        pad = conv_state.to(xbc.dtype)
    xbc_pad = torch.cat([pad, xbc], dim=1)
    new_conv_state = xbc_pad[:, -(CONV_W - 1):, :]
    conv = sum(xbc_pad[:, i:i + S, :] * conv_w[i][None, None, :]
               for i in range(CONV_W)) + conv_b
    conv = F.silu(conv)

    xs, Bm, Cm = torch.split(conv, [d_inner, d_state, d_state], dim=-1)
    xh = xs.reshape(B, S, H, headdim)
    A = -torch.exp(A_log)                                          # (H,) < 0

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
    y = y + Dskip[None, None, :, None].float() * xh.float()
    y = y.reshape(B, S, d_inner).to(x.dtype)

    # gated RMSNorm (Mamba2): norm(y * silu(z))
    y = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        y = rmsnorm(y, norm, kernels=kernels) @ params["out_proj"]
    else:
        y = reduce_from(rmsnorm_split(y, norm, tp) @ params["out_proj"], tp,
                        "model")
    return y, (s_final, new_conv_state)
