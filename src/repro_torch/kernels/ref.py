"""Plain PyTorch versions of the port's kernels: the ground truth each CUDA
kernel is held against, and what a wrapper runs on CPU tensors.

The prefix ops keep the JAX package's shift-doubling order
(`repro/kernels/ref.py`), so float32 sums associate as the reference's do.
The attention and norm versions compute in float32 and return the input's
type, as the reference's oracles do; the attention ones also take grouped
KV heads (Hq = G * Hkv, query head h reads KV head h // G), which is the
reference's function at G = 1.  The two scans return their final state
beside their output and take an initial one (the extension the model path
needs, see `repro_torch.kernels.ssd_scan`); at a zero initial state the
output is the reference's function.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30

# Tolerances (rtol = atol) at which a kernel is held against its plain
# version on the card. Scans: the reference's 2e-4 (tests/test_kernels.py:
# 82-109) for float32 outputs and for the float32 states; in bfloat16 both
# versions compute in float32 from the same bf16 inputs and round the
# output once to bf16 (relative 2**-8), so the output is held at the bf16
# tolerance 2e-2. moe_gemm: the reference's (tests/test_kernels.py:64-67).
SCAN_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
STATE_TOL = 2e-4
MOE_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis by shift-doubling."""
    k = 1
    w = x.shape[-1]
    while k < w:
        pad = x.new_zeros(x.shape[:-1] + (k,))
        x = x + torch.cat([pad, x[..., :-k]], dim=-1)
        k *= 2
    return x


def prefix_max(x: torch.Tensor, identity: float = NEG) -> torch.Tensor:
    """Inclusive prefix max over the last axis by shift-doubling."""
    k = 1
    w = x.shape[-1]
    while k < w:
        pad = x.new_full(x.shape[:-1] + (k,), identity)
        x = torch.maximum(x, torch.cat([pad, x[..., :-k]], dim=-1))
        k *= 2
    return x


def serialize_prefix_ref(free0: torch.Tensor, release: torch.Tensor,
                         dur: torch.Tensor):
    """FCFS prefix-serialization of independent resources over ordered items.

    ``free0``: (..., R) — time each resource becomes available; ``release``/
    ``dur``: (..., R, W) — per-item earliest start and occupancy duration on
    its resource, in FCFS service order along the last axis. Implements the
    queue recurrence ``f_k = max(f_{k-1}, r_k) + d_k`` (``f_0 = free0``) in
    closed form: with ``S_k = cumsum(d)`` the recurrence unrolls to
    ``f_k = S_k + max(free0, cummax_k(r_k - S_{k-1}))``. Items not on a
    resource are encoded as ``d = 0, r = -1e30``. Returns ``(finish (..., R,
    W), new_free (..., R))``.
    """
    s = prefix_sum(dur)
    g = release - (s - dur)
    run = torch.maximum(prefix_max(g), free0[..., None])
    fin = s + run
    return fin, fin[..., -1]


def population_last(serialize):
    """`serialize` (queues as contiguous (rows, W) rows, FCFS order on the
    minor axis) as a function of population-last tensors: (R, P) free and
    (R, W, P) items, laid out as (P, R, W) rows for the call and pivoted
    back as views."""
    def ser_t(free0, release, dur):
        fin, free = serialize(free0.t().contiguous(),
                              release.permute(2, 0, 1).contiguous(),
                              dur.permute(2, 0, 1).contiguous())
        return fin.permute(1, 2, 0), free.t()
    return ser_t


def _amax(x: torch.Tensor, dim: int, initial: float) -> torch.Tensor:
    """Max over `dim` with a floor, as `numpy.max(x, axis=dim, initial=)`."""
    return torch.clamp_min(torch.amax(x, dim=dim), initial)


def _pmax0(a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix max along axis 0 by shift-doubling."""
    k = 1
    while k < a.shape[0]:
        pad = a.new_full((k,) + tuple(a.shape[1:]), NEG)
        a = torch.maximum(a, torch.cat([pad, a[:-k]], dim=0))
        k *= 2
    return a


SEGMENTS = ("greedy", "strict", "none")


def segments_ref(genomes: torch.Tensor, layer_wb: torch.Tensor,
                 w_cap: torch.Tensor) -> torch.Tensor:
    """(P, G) fused-stack segment ids of (P, G) genomes, replicating the
    engine's `_segments_from_arrays`: a greedy cut when a core's accumulated
    weight footprint overflows its weight memory."""
    p = genomes.shape[0]
    rows = torch.arange(p, device=genomes.device)
    acc_w = torch.zeros((p, w_cap.shape[0]), dtype=torch.float32,
                        device=genomes.device)
    seg = torch.zeros(p, dtype=torch.int64, device=genomes.device)
    segs = []
    for layer in range(genomes.shape[1]):
        core = genomes[:, layer]
        wb = layer_wb[layer]
        cap = w_cap[core]
        hold = torch.minimum(wb, cap)
        held = acc_w[rows, core]
        active = (wb > 0) & (cap > 0)
        cut = active & (held + hold > cap) & (held > 0)
        seg = seg + cut.to(seg.dtype)
        acc_w = torch.where(cut[:, None], 0.0, acc_w)
        add = torch.where(active, hold, 0.0)
        acc_w = acc_w.index_put((rows, core), add, accumulate=True)
        segs.append(seg)
    return torch.stack(segs, dim=1)


def wavefront_scan_ref(genomes: torch.Tensor, xs: dict, st: dict, *, n: int,
                       n_chan: int, segment: str = "greedy", serialize=None):
    """The GA prefilter's scan over wavefronts (the loop of
    `repro_torch.core.vectorized.BatchedFitness`), for one chunk of genomes.

    ``genomes``: (P, G) int64 core per layer.  ``xs``: the chunk's hoisted
    per-wavefront tensors, population last: "cyc", "cw" (L, W, P) cycles and
    core of each slot; "on" (L, C, W, P) slot-on-core masks under
    serialization, or "sc" (L, C, P) per-core cycle sums under the backlog
    model; with channel transfers "cross" (L, W, D, P) and "occ" (L, H, W,
    P); with the spill model "aw", "mw" (L, W, P) and "ac", "fc" (L, C, P).
    ``st``: the static tables "wf", "member", "wf_layer", "dram" (L, W),
    "tot" (L,), "act_cap", "w_cap" (C,), "layer_wb" (G,) and, when CNs have
    predecessors, "pu" (L, W, D).  ``segment``: "greedy" (the cut of
    `segments_ref`), "strict" (a segment per layer) or "none".
    ``serialize``: a population-last FCFS serialization (see
    `population_last`), or None for the backlog model.

    Returns population-last ``(finish (n+1, P), core_free (C, P), chan_free
    (max(H, 1), P), dram_free (P,), spilled (n+1, P), dram_x (P,))``.
    """
    if segment not in SEGMENTS:
        raise ValueError(f"unknown segment mode {segment!r}")
    dev = genomes.device
    p = genomes.shape[0]
    n_cores = st["w_cap"].shape[0]
    if segment == "strict":
        seg_gl = torch.arange(genomes.shape[1], device=dev)[None].expand(
            genomes.shape)
    elif segment == "greedy":
        seg_gl = segments_ref(genomes, st["layer_wb"], st["w_cap"])
    else:
        seg_gl = torch.zeros_like(genomes)
    seg_x = seg_gl.t()[st["wf_layer"]]                # (L, W, P)

    comm = "cross" in xs
    spills = "ac" in xs
    dmax = "pu" in st
    act_cap = st["act_cap"][:, None]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    finish = zeros(n + 1, p)
    core_free = zeros(n_cores, p)
    chan_free = zeros(max(n_chan, 1), p)
    dram_free = zeros(p)
    seg_front = zeros(genomes.shape[1], p)
    used = zeros(n_cores, p)
    spilled = zeros(n + 1, p)
    dram_x = zeros(p)
    neg_row = torch.full((1, p), NEG, dtype=torch.float32, device=dev)

    for lv in range(st["wf"].shape[0]):
        x = {k: v[lv] for k, v in xs.items()}
        wf, seg = st["wf"][lv], seg_x[lv]
        if dmax:
            pf = finish[st["pu"][lv]]                 # (W, D, P)
            if comm:
                base = _amax(torch.where(x["cross"], NEG, pf), 1,
                             0.0)                     # same-core producers
                rel_b = _amax(torch.where(x["cross"], pf, NEG), 1,
                              NEG)                    # (W, P) bundle release
                occ_t = x["occ"]                      # (n_chan, W, P)
                rel_t = torch.where(occ_t > 0, rel_b[None], NEG)
                if serialize is not None:
                    fin_ch, chan_free = serialize(chan_free, rel_t, occ_t)
                else:
                    fin_ch = torch.maximum(rel_t,
                                           chan_free[:, None]) + occ_t
                    chan_free = torch.maximum(
                        chan_free + torch.sum(occ_t, dim=1),
                        torch.amax(torch.where(occ_t > 0, fin_ch, NEG),
                                   dim=1))
                arr = torch.amax(torch.where(occ_t > 0, fin_ch, NEG),
                                 dim=0)
                data_ready = torch.maximum(base, arr)
            else:
                data_ready = _amax(pf, 1, 0.0)
        else:
            data_ready = zeros(wf.shape[0], p)

        # DRAM port: external inputs then layer-head weights, FCFS in
        # wavefront order (release 0 — JIT prefetch staging is dropped); end
        # offsets are static, NEG marks "no fetch"
        ready = torch.maximum(data_ready,
                              dram_free[None] + st["dram"][lv][:, None])
        dram_free = dram_free + st["tot"][lv]

        # fused-stack barrier: a segment starts no earlier than the max
        # finish of every earlier segment (exclusive prefix-max over the
        # per-segment frontiers, gathered per item)
        ex = torch.cat([neg_row, _pmax0(seg_front)[:-1]], dim=0)
        barrier = torch.gather(ex, 0, seg)
        ready = torch.maximum(ready, barrier)

        # per-core FCFS queue update — the (n_cores x P) step
        mem = st["member"][lv][:, None]
        if serialize is not None:
            on_core = x["on"]                         # (C, W, P)
            rel_c = torch.where(on_core, ready[None], NEG)
            dur_c = torch.where(on_core, x["cyc"][None], 0.0)
            fin_c, core_free = serialize(core_free, rel_c, dur_c)
            fin_w = torch.sum(torch.where(on_core, fin_c, 0.0), dim=0)
        else:
            cf_w = torch.gather(core_free, 0, x["cw"])
            fin_w = torch.where(
                mem, torch.maximum(ready, cf_w) + x["cyc"], 0.0)
            core_free = (core_free + x["sc"]).scatter_reduce_(
                0, x["cw"], torch.where(mem, fin_w, NEG), "amax")

        # activation-memory occupancy and spills, aggregated per wavefront:
        # overflow beyond a core's activation capacity is written out
        # (`spill_w`) and every consumer edge of a spilled producer reads its
        # share back (`spill_r`, resolved by the caller after the scan), both
        # through the DRAM port
        if spills:
            alloc_c = x["ac"]                         # (C, P)
            over = torch.minimum(
                torch.clamp_min(used + alloc_c - act_cap, 0.0), alloc_c)
            frac = over / torch.clamp_min(alloc_c, 1.0)
            frac_w = torch.gather(frac, 0, x["mw"])
            # the pad row n takes every non-member's 0.0
            spilled.index_add_(0, wf, torch.where(mem, x["aw"] * frac_w, 0.0))
            dram_x = dram_x + torch.sum(over, dim=0)
            used = torch.clamp_min(
                torch.minimum(used + alloc_c - over, act_cap) - x["fc"], 0.0)

        # non-members write 0.0 to the pad row n, which keeps finish[n] == 0
        # for the pad predecessor slots
        finish.index_put_((wf,), fin_w)
        seg_front.scatter_reduce_(0, seg, torch.where(mem, fin_w, NEG),
                                  "amax")
    return finish, core_free, chan_free, dram_free, spilled, dram_x


def _grouped_scores(q, k):
    """float32 scores of q (B, Hq, S, D) against k (B, Hkv, T, D), scaled by
    1/sqrt(D), as (B, Hkv, G, S, T)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qg = q.float().reshape(B, Hkv, Hq // Hkv, S, D)
    return torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) / math.sqrt(D)


def _softmax_attention(q, k, v, causal: bool, diagonal: int):
    """Naive softmax attention, the causal mask `tril(diagonal)`."""
    B, Hq, S, D = q.shape
    T = k.shape[2]
    s = _grouped_scores(q, k)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool,
                          device=q.device).tril(diagonal)
        s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return out.reshape(B, Hq, S, v.shape[-1]).to(q.dtype)


def flash_attention_ref(q, k, v, causal: bool = True):
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D) -> (B,Hq,S,D). Naive softmax
    attention; the causal mask is the reference oracle's `tril(k=T-S)`,
    which aligns it bottom-right: the oracle at S = T only."""
    return _softmax_attention(q, k, v, causal, k.shape[2] - q.shape[2])


def flash_attention_top_left_ref(q, k, v, causal: bool = True):
    """As `flash_attention_ref`, with the causal mask aligned top-left
    (query i sees keys j <= i, so rows i >= T see every key), as the TPU
    kernel (`repro/kernels/flash_attention.py:44-47`), both CUDA kernels and
    `models.layers.blocked_attention` align it: the plain version for
    causal S != T. At S = T the two masks are one."""
    return _softmax_attention(q, k, v, causal, 0)


def mla_attention_ref(q, kn, kr, v, *, scale: float):
    """MLA's causal prefill attention: q (B, S, H, Dn + Dr) against keys
    whose first Dn columns are kn (B, T, H, Dn) and whose last Dr are the
    shared kr (B, T, Dr), values v (B, T, H, Dv) -> (B, S, H, Dv) in q's
    type.  Naive softmax in float32 with the scores times `scale`, the
    causal mask aligned top-left, p rounded to v's type before the P V
    product and the sum normalised after it, as the reference's blocked
    attention does (`repro/models/layers.py:156-158`).  The MLA wrapper's
    version for CPU tensors and the card tests' oracle: its (B, H, S, T)
    scores are no model path's (the model's plain MLA prefill is
    `blocked_attention` on per-head keys)."""
    S, T, Dn = q.shape[1], kn.shape[1], kn.shape[-1]
    qf = q.float()
    s = (torch.einsum("bshd,bthd->bhst", qf[..., :Dn], kn.float())
         + torch.einsum("bshd,btd->bhst", qf[..., Dn:], kr.float())) * scale
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1).clamp_min(1e-30).transpose(1, 2)[..., None]
    out = torch.einsum("bhst,bthd->bshd", p.to(v.dtype).float(), v.float())
    return (out / l).to(q.dtype)


def decode_attention_ref(q, k, v, cur_len):
    """q: (B,Hq,D); k,v: (B,Hkv,T,D); valid positions < cur_len."""
    B, Hq, D = q.shape
    T = k.shape[2]
    s = _grouped_scores(q[:, :, None], k)[..., 0, :]        # (B,Hkv,G,T)
    valid = torch.arange(T, device=q.device) < cur_len
    s = torch.where(valid, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v.float())
    return out.reshape(B, Hq, v.shape[-1]).to(q.dtype)


def moe_gemm_ref(x, w):
    """Capacity-layout grouped GEMM. x: (E,C,K); w: (E,K,N) -> (E,C,N)."""
    return torch.einsum("eck,ekn->ecn", x.float(), w.float()).to(x.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm, initial_state=None):
    """Per-token SSD recurrence (see models.ssm.ssd_scan_oracle).

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm,Cm: (B,S,N); initial_state:
    float32 (B,H,P,N) or None -> (y (B,S,H,P), final state (B,H,P,N))."""
    from repro_torch.models.ssm import ssd_scan_oracle
    return ssd_scan_oracle(x, dt, A, Bm, Cm, initial_state)


def rwkv6_scan_ref(r, k, v, logw, u, initial_state=None):
    """Per-token RWKV6 recurrence (see models.rwkv.rwkv6_scan_oracle) ->
    (o (B,S,H,V), final state (B,H,K,V))."""
    from repro_torch.models.rwkv import rwkv6_scan_oracle
    return rwkv6_scan_oracle(r, k, v, logw, u, initial_state)
