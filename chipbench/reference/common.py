"""Plain float32 building blocks of the benchmark's references.

Nothing here imports the program under test or JAX: the references are the
yardstick the program's outputs are judged by.  Every product goes through
a `Precision`, so the same model code computes the reference (float32,
TF32 off) and its control (the same arithmetic with every product's
operands rounded to float8 e4m3 under a per-tensor scale, the step below
the configuration's bfloat16 that a later change could be tempted by).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0         # largest finite float8 e4m3 value


def no_tf32() -> None:
    """float32 products in float32 on the card (not TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Fp8Round(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale, gradient passed
    through unchanged (the products' backward then reads the rounded
    values, as a float8 step would)."""

    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = amax / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    """How the reference's products are computed: "float32" or "fp8" (the
    control)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x):
        return _Fp8Round.apply(x) if self.name == "fp8" else x

    def mm(self, a, b):
        """a (..., K) @ b (K, N) in float32."""
        return self.q(a.float()) @ self.q(b.float())


FLOAT32 = Precision("float32")


def rmsnorm(x, scale, eps: float = 1e-5):
    x = x.float()
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, positions, theta: float):
    """Rotate the two halves of x's last axis (B, T, H, D) by position
    times theta ** (-2i / D)."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=F32, device=x.device) / d)
    ang = positions.to(F32)[:, None] * inv[None, :]          # (T, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, prec: Precision, block: int = 512):
    """Softmax attention with a causal mask, q, k, v (B, T, H, D), in
    blocks of query rows; every head reads its own keys."""
    B, T, H, D = q.shape
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, T, D)
    scale = 1.0 / math.sqrt(D)
    kpos = torch.arange(T, device=q.device)
    outs = []
    for lo in range(0, T, block):
        hi = min(lo + block, T)
        s = prec.mm(qh[:, :, lo:hi], kh.transpose(-1, -2)) * scale
        qpos = torch.arange(lo, hi, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        outs.append(prec.mm(torch.softmax(s, dim=-1), vh))
    return torch.cat(outs, dim=2).transpose(1, 2)             # (B, T, H, D)


def glu(p, x, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, p["gate"])) * prec.mm(x, p["up"]),
                   p["down"])


def token_shift(x, last=None):
    """x[t - 1] at t, `last` (zeros when None) at t = 0; x (B, T, D)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def cross_entropy(x, head, labels, prec: Precision, block: int = 512):
    """Mean softmax cross entropy of the final hidden rows x (B, S, D)
    against the head (V, D), a block of positions at a time, each under a
    checkpoint so its (B, block, V) logits never live through backward."""
    B, S, _ = x.shape

    def part(xb, lb):
        logits = prec.mm(xb, head.t())
        return torch.sum(torch.logsumexp(logits, dim=-1) -
                         torch.gather(logits, -1, lb[..., None])[..., 0])

    total = x.new_zeros((), dtype=F32)
    for lo in range(0, S, block):
        hi = min(lo + block, S)
        total = total + checkpoint(part, x[:, lo:hi], labels[:, lo:hi],
                                   use_reentrant=False)
    return total / (B * S)


def layer_params(tree, i: int):
    """Layer `i` of a stacked parameter tree, as float32."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i].float()


def as_float(tree):
    if isinstance(tree, dict):
        return {k: as_float(v) for k, v in tree.items()}
    return tree.float()
