"""LLM serving workloads: prefill/decode phase DAGs for the Stream core.

Maps the `repro_torch.models` families (transformer / RWKV / SSM) onto the
Workload IR so the scheduling engine can price their two serving phases:

* **prefill** — the whole prompt in one pass: every GEMM is a 1x1 conv
  whose OY axis is the *token* axis (`OY=seq_len`), so Stream's row-band
  granularities split prefill into token bands and layer fusion streams
  tokens through the fabric (the StreamTensor framing).
* **decode** — one token (`OY=1`) against a `kv_len`-deep context.

Approximations, stated once: attention score/context GEMMs carry "weights"
of size ``seq x d`` standing in for the KV-cache traffic their operands
really are; embedding table lookups and the LM head are omitted (pure
memory traffic priced nowhere near the MAC arrays); elementwise mixers
(RWKV's WKV scan, the SSM selective scan, residual adds) are SIMD-mapped
ops, matching the paper's pool/add treatment.

Each builder returns the *prefill* `Workload` with the decode-phase DAG
attached as ``wl.serving_decode`` (plus ``wl.serving_family``) — a single
object carries both phases through a `DesignSpace` while each phase is
scheduled as its own workload with its own content key.
"""
from __future__ import annotations

from repro_torch.core.workload import Workload

SERVING_FAMILIES = ("transformer", "rwkv", "ssm")


def decode_phase_of(workload: Workload) -> "Workload | None":
    """The decode-phase DAG attached to a serving workload, else None.

    A plain workload (CNN inference: one-shot requests, no token loop)
    has no decode phase — the simulator then treats the whole inference
    as the "prefill" and completes requests after it.

        >>> wl = transformer_phases(d_model=32, n_layers=1, seq_len=8)
        >>> decode_phase_of(wl) is wl.serving_decode
        True
        >>> from repro_torch.configs.paper_workloads import fsrcnn
        >>> decode_phase_of(fsrcnn()) is None
        True
    """
    return getattr(workload, "serving_decode", None)


def _gemm(w: Workload, name: str, src: "int | None", k: int, c: int,
          tokens: int) -> int:
    """A token-axis GEMM: 1x1 conv with OY = the token axis."""
    return w.add(name, "conv", {"B": 1, "K": k, "C": c, "OY": tokens,
                                "OX": 1, "FY": 1, "FX": 1},
                 inputs=() if src is None else (src,))


def _simd(w: Workload, name: str, src: int, k: int, tokens: int) -> int:
    """An elementwise/scan op over the token axis (SIMD-mapped pool)."""
    return w.add(name, "pool", {"B": 1, "K": k, "OY": tokens, "OX": 1,
                                "FY": 1, "FX": 1}, inputs=(src,))


def _attach(prefill: Workload, decode: Workload, family: str) -> Workload:
    prefill.serving_decode = decode
    prefill.serving_family = family
    return prefill


def _transformer(name: str, tokens: int, kv: int, d_model: int,
                 n_layers: int, d_ff: int) -> Workload:
    w = Workload(name)
    prev = None
    for i in range(n_layers):
        qkv = _gemm(w, f"L{i}.qkv", prev, 3 * d_model, d_model, tokens)
        scores = _gemm(w, f"L{i}.scores", qkv, kv, 3 * d_model, tokens)
        ctx = _gemm(w, f"L{i}.ctx", scores, d_model, kv, tokens)
        proj = _gemm(w, f"L{i}.proj", ctx, d_model, d_model, tokens)
        res = qkv if prev is None else prev
        attn = w.add(f"L{i}.res_attn", "add",
                     {"B": 1, "K": d_model, "OY": tokens, "OX": 1},
                     inputs=(proj, res))
        up = _gemm(w, f"L{i}.up", attn, d_ff, d_model, tokens)
        down = _gemm(w, f"L{i}.down", up, d_model, d_ff, tokens)
        prev = w.add(f"L{i}.res_ffn", "add",
                     {"B": 1, "K": d_model, "OY": tokens, "OX": 1},
                     inputs=(down, attn))
    return w


def transformer_phases(name: str = "tfm", *, d_model: int = 128,
                       n_layers: int = 2, d_ff: "int | None" = None,
                       seq_len: int = 64, kv_len: "int | None" = None,
                       ) -> Workload:
    """GQA-style transformer decoder: QKV / scores / context / out GEMMs
    plus a 2-GEMM FFN and residual adds, per layer.

        >>> wl = transformer_phases(d_model=64, n_layers=1, seq_len=16)
        >>> len(wl), len(wl.serving_decode), wl.serving_family
        (8, 8, 'transformer')
        >>> wl.layers[1].name, wl.layers[1].d("K")    # scores GEMM: K = kv
        ('L0.scores', 16)
        >>> wl.serving_decode.layers[0].d("OY")       # decode: 1 token
        1
    """
    d_ff = 4 * d_model if d_ff is None else d_ff
    kv_len = seq_len if kv_len is None else kv_len
    prefill = _transformer(name, seq_len, seq_len, d_model, n_layers, d_ff)
    decode = _transformer(f"{name}#decode", 1, kv_len, d_model, n_layers,
                          d_ff)
    return _attach(prefill, decode, "transformer")


def _rwkv(name: str, tokens: int, d_model: int, n_layers: int,
          d_ff: int) -> Workload:
    w = Workload(name)
    prev = None
    for i in range(n_layers):
        tm = _gemm(w, f"L{i}.time_mix", prev, 4 * d_model, d_model, tokens)
        wkv = _simd(w, f"L{i}.wkv", tm, 4 * d_model, tokens)
        out = _gemm(w, f"L{i}.out", wkv, d_model, 4 * d_model, tokens)
        cm = _gemm(w, f"L{i}.chan_mix", out, d_ff, d_model, tokens)
        prev = _gemm(w, f"L{i}.chan_out", cm, d_model, d_ff, tokens)
    return w


def rwkv_phases(name: str = "rwkv", *, d_model: int = 128, n_layers: int = 2,
                d_ff: "int | None" = None, seq_len: int = 64) -> Workload:
    """RWKV-6 block: fused r/k/v/g time-mix GEMM, the WKV recurrence as a
    SIMD scan over tokens, output projection, and the 2-GEMM channel mix.
    Decode is the same chain at one token — the recurrent state makes the
    per-token shape independent of context length.

        >>> wl = rwkv_phases(d_model=64, n_layers=1, seq_len=16)
        >>> [wl.layers[i].op for i in range(len(wl))]
        ['conv', 'pool', 'conv', 'conv', 'conv']
        >>> len(wl.serving_decode) == len(wl)
        True
    """
    d_ff = 4 * d_model if d_ff is None else d_ff
    prefill = _rwkv(name, seq_len, d_model, n_layers, d_ff)
    decode = _rwkv(f"{name}#decode", 1, d_model, n_layers, d_ff)
    return _attach(prefill, decode, "rwkv")


def _ssm(name: str, tokens: int, d_model: int, n_layers: int,
         d_inner: int, d_conv: int) -> Workload:
    w = Workload(name)
    prev = None
    for i in range(n_layers):
        inp = _gemm(w, f"L{i}.in_proj", prev, 2 * d_inner, d_model, tokens)
        conv = w.add(f"L{i}.conv1d", "dwconv",
                     {"B": 1, "K": 2 * d_inner, "OY": tokens, "OX": 1,
                      "FY": d_conv, "FX": 1},
                     padding=d_conv - 1, inputs=(inp,))
        scan = _simd(w, f"L{i}.scan", conv, 2 * d_inner, tokens)
        prev = _gemm(w, f"L{i}.out_proj", scan, d_model, d_inner, tokens)
    return w


def ssm_phases(name: str = "ssm", *, d_model: int = 128, n_layers: int = 2,
               d_inner: "int | None" = None, d_conv: int = 4,
               seq_len: int = 64) -> Workload:
    """Mamba-style SSM block: input projection, depthwise causal conv over
    the token axis, the selective scan as a SIMD op, output projection.
    Decode is one recurrent step (OY=1), context-length independent.

        >>> wl = ssm_phases(d_model=64, n_layers=1, seq_len=16)
        >>> [wl.layers[i].op for i in range(len(wl))]
        ['conv', 'dwconv', 'pool', 'conv']
        >>> wl.serving_decode.layers[1].d("FY")   # conv window survives
        4
    """
    d_inner = 2 * d_model if d_inner is None else d_inner
    prefill = _ssm(name, seq_len, d_model, n_layers, d_inner, d_conv)
    decode = _ssm(f"{name}#decode", 1, d_model, n_layers, d_inner, d_conv)
    return _attach(prefill, decode, "ssm")


SERVING_WORKLOADS = {
    "transformer": transformer_phases,
    "rwkv": rwkv_phases,
    "ssm": ssm_phases,
}


def serving_workload(family: str, **kw) -> Workload:
    """Build a serving workload by family name.

        >>> serving_workload("rwkv", d_model=32, n_layers=1,
        ...                  seq_len=8).serving_family
        'rwkv'
        >>> serving_workload("gpt5")
        Traceback (most recent call last):
            ...
        KeyError: "unknown serving family 'gpt5' (have: transformer, rwkv, ssm)"
    """
    try:
        build = SERVING_WORKLOADS[family]
    except KeyError:
        raise KeyError(f"unknown serving family {family!r} "
                       f"(have: {', '.join(SERVING_WORKLOADS)})") from None
    return build(**kw)
