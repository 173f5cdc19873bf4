"""The paper's workload targets as Stream workload graphs.

Exploration set (paper Sec. V): ResNet-18 [17], MobileNetV2 [33],
SqueezeNet [20], Tiny-YOLO [1], FSRCNN [10].
Validation set (paper Sec. IV): FSRCNN @560x960 (DepFiN), ResNet-50 segment
(4x4 AiMC), ResNet-18 first segment (DIANA).

All networks are 8-bit (edge deployment, as in the paper's studies).
"""
from __future__ import annotations

from repro_torch.core.workload import Workload


# ---------------------------------------------------------------------------
# layer-construction helpers
# ---------------------------------------------------------------------------

def _conv(w: Workload, name: str, src: int | None, k: int, c: int, oy: int, ox: int,
          f: int = 3, stride: int = 1) -> int:
    return w.add(name, "conv", {"K": k, "C": c, "OY": oy, "OX": ox, "FY": f, "FX": f},
                 stride=stride, padding=f // 2, inputs=() if src is None else (src,))


def _dw(w: Workload, name: str, src: int, k: int, oy: int, ox: int,
        f: int = 3, stride: int = 1) -> int:
    return w.add(name, "dwconv", {"K": k, "OY": oy, "OX": ox, "FY": f, "FX": f},
                 stride=stride, padding=f // 2, inputs=(src,))


def _pool(w: Workload, name: str, src: int, k: int, oy: int, ox: int,
          f: int = 2, stride: int = 2) -> int:
    return w.add(name, "pool", {"K": k, "OY": oy, "OX": ox, "FY": f, "FX": f},
                 stride=stride, inputs=(src,))


def _add(w: Workload, name: str, a: int, b: int, k: int, oy: int, ox: int) -> int:
    return w.add(name, "add", {"K": k, "OY": oy, "OX": ox}, inputs=(a, b))


def _fc(w: Workload, name: str, src: int, k: int, c: int) -> int:
    return w.add(name, "fc", {"K": k, "C": c}, inputs=(src,))


# ---------------------------------------------------------------------------
# exploration workloads
# ---------------------------------------------------------------------------

def resnet18(input_res: int = 224) -> Workload:
    w = Workload("resnet18")
    s = input_res // 2  # 112
    x = _conv(w, "conv1", None, 64, 3, s, s, f=7, stride=2)
    s //= 2  # 56
    x = _pool(w, "maxpool", x, 64, s, s, f=3, stride=2)
    ch = 64
    for stage, (k, blocks) in enumerate([(64, 2), (128, 2), (256, 2), (512, 2)]):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            if stride == 2:
                s //= 2
            ident = x
            y = _conv(w, f"s{stage}b{b}c1", x, k, ch if b == 0 else k, s, s, f=3, stride=stride)
            y = _conv(w, f"s{stage}b{b}c2", y, k, k, s, s, f=3)
            if stride == 2 or (b == 0 and ch != k):
                ident = _conv(w, f"s{stage}b{b}ds", ident, k, ch, s, s, f=1, stride=stride)
            x = _add(w, f"s{stage}b{b}add", y, ident, k, s, s)
        ch = k
    x = _pool(w, "avgpool", x, 512, 1, 1, f=s, stride=s)
    _fc(w, "fc", x, 1000, 512)
    return w


def mobilenetv2(input_res: int = 224) -> Workload:
    w = Workload("mobilenetv2")
    s = input_res // 2
    x = _conv(w, "conv1", None, 32, 3, s, s, f=3, stride=2)
    ch = 32
    cfg = [  # (expansion t, out channels, repeats, stride)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    for i, (t, c, reps, stride0) in enumerate(cfg):
        for r in range(reps):
            stride = stride0 if r == 0 else 1
            hidden = ch * t
            inp = x
            y = x
            if t != 1:
                y = _conv(w, f"b{i}r{r}expand", y, hidden, ch, s, s, f=1)
            if stride == 2:
                s //= 2
            y = _dw(w, f"b{i}r{r}dw", y, hidden, s, s, f=3, stride=stride)
            y = _conv(w, f"b{i}r{r}proj", y, c, hidden, s, s, f=1)
            if stride == 1 and ch == c:
                y = _add(w, f"b{i}r{r}add", y, inp, c, s, s)
            x, ch = y, c
    x = _conv(w, "conv_last", x, 1280, 320, s, s, f=1)
    x = _pool(w, "avgpool", x, 1280, 1, 1, f=s, stride=s)
    _fc(w, "fc", x, 1000, 1280)
    return w


def squeezenet(input_res: int = 224) -> Workload:
    w = Workload("squeezenet")

    def fire(x: int, s: int, sq: int, e1: int, e3: int, cin: int, tag: str) -> int:
        sqz = _conv(w, f"{tag}sq", x, sq, cin, s, s, f=1)
        a = _conv(w, f"{tag}e1", sqz, e1, sq, s, s, f=1)
        b = _conv(w, f"{tag}e3", sqz, e3, sq, s, s, f=3)
        return w.add(f"{tag}cat", "concat", {"K": e1 + e3, "OY": s, "OX": s},
                     inputs=(a, b))

    s = input_res // 2 - 3  # 7x7/2 valid-ish -> 109 for 224; keep it simple
    s = 111
    x = _conv(w, "conv1", None, 96, 3, s, s, f=7, stride=2)
    s = 55
    x = _pool(w, "pool1", x, 96, s, s, f=3, stride=2)
    x = fire(x, s, 16, 64, 64, 96, "f2")
    x = fire(x, s, 16, 64, 64, 128, "f3")
    x = fire(x, s, 32, 128, 128, 128, "f4")
    s = 27
    x = _pool(w, "pool4", x, 256, s, s, f=3, stride=2)
    x = fire(x, s, 32, 128, 128, 256, "f5")
    x = fire(x, s, 48, 192, 192, 256, "f6")
    x = fire(x, s, 48, 192, 192, 384, "f7")
    x = fire(x, s, 64, 256, 256, 384, "f8")
    s = 13
    x = _pool(w, "pool8", x, 512, s, s, f=3, stride=2)
    x = fire(x, s, 64, 256, 256, 512, "f9")
    x = _conv(w, "conv10", x, 1000, 512, s, s, f=1)
    _pool(w, "avgpool", x, 1000, 1, 1, f=s, stride=s)
    return w


def tiny_yolo(input_res: int = 416) -> Workload:
    w = Workload("tiny_yolo")
    s = input_res
    x = _conv(w, "c0", None, 16, 3, s, s, f=3)
    chans = [32, 64, 128, 256, 512]
    ch = 16
    for i, k in enumerate(chans):
        s //= 2
        x = _pool(w, f"p{i}", x, ch, s, s, f=2, stride=2)
        x = _conv(w, f"c{i + 1}", x, k, ch, s, s, f=3)
        ch = k
    x = _pool(w, "p5", x, 512, s, s, f=2, stride=1)   # stride-1 pool
    x = _conv(w, "c6", x, 1024, 512, s, s, f=3)
    x = _conv(w, "c7", x, 256, 1024, s, s, f=1)
    x = _conv(w, "c8", x, 512, 256, s, s, f=3)
    _conv(w, "det", x, 255, 512, s, s, f=1)
    return w


def fsrcnn(oy: int = 560, ox: int = 960) -> Workload:
    """FSRCNN (d=56, s=12, m=4) on DepFiN's 560x960 frames.

    The 9x9/2 deconv is expressed in its standard 2x2-subpixel decomposition:
    K=4 subpixel output channels with ~5x5 effective taps each (a stride-2
    transposed conv touches only every other tap per output phase), matching
    the deconv's true MAC count instead of the zero-inserted 9x9 grid.
    """
    w = Workload("fsrcnn")
    x = _conv(w, "feat", None, 56, 1, oy, ox, f=5)
    x = _conv(w, "shrink", x, 12, 56, oy, ox, f=1)
    for i in range(4):
        x = _conv(w, f"map{i}", x, 12, 12, oy, ox, f=3)
    x = _conv(w, "expand", x, 56, 12, oy, ox, f=1)
    _conv(w, "deconv", x, 4, 56, oy, ox, f=5)  # 4 = 2x2 subpixel channels
    return w


# ---------------------------------------------------------------------------
# validation workloads
# ---------------------------------------------------------------------------

def resnet50_segment() -> Workload:
    """ResNet-50 conv2_x segment (the stem runs off-chip in Jia et al.'s
    measurement): three bottleneck blocks + next-stage entry convs, pipelined
    across the 4x4 AiMC cores [21] (one dense layer per core)."""
    w = Workload("resnet50_segment")
    s = 56
    x = w.add("input_proj", "conv",
              {"K": 64, "C": 64, "OY": s, "OX": s, "FY": 1, "FX": 1})
    ch = 64
    for b in range(3):  # three bottleneck blocks = 9 convs + downsample + adds
        ident = x
        y = _conv(w, f"b{b}c1", x, 64, ch, s, s, f=1)
        y = _conv(w, f"b{b}c2", y, 64, 64, s, s, f=3)
        y = _conv(w, f"b{b}c3", y, 256, 64, s, s, f=1)
        if ch != 256:
            ident = _conv(w, f"b{b}ds", ident, 256, ch, s, s, f=1)
        x = _add(w, f"b{b}add", y, ident, 256, s, s)
        ch = 256
    # entry convs of the next stage to reach 16 dense layers
    y = _conv(w, "n0c1", x, 128, 256, s, s, f=1)
    y = _conv(w, "n0c2", y, 128, 128, 28, 28, f=3, stride=2)
    _conv(w, "n0c3", y, 512, 128, 28, 28, f=1)
    return w


def resnet18_first_segment() -> Workload:
    """ResNet-18 first segment (conv1 .. first two basic blocks), the DIANA
    [38] measurement workload (conv / pooling / element-wise sum operators)."""
    w = Workload("resnet18_seg1")
    s = 112
    x = _conv(w, "conv1", None, 64, 3, s, s, f=7, stride=2)
    s = 56
    x = _pool(w, "maxpool", x, 64, s, s, f=3, stride=2)
    for b in range(2):
        ident = x
        y = _conv(w, f"b{b}c1", x, 64, 64, s, s, f=3)
        y = _conv(w, f"b{b}c2", y, 64, 64, s, s, f=3)
        x = _add(w, f"b{b}add", y, ident, 64, s, s)
    return w


EXPLORATION_WORKLOADS = {
    "resnet18": resnet18,
    "mobilenetv2": mobilenetv2,
    "squeezenet": squeezenet,
    "tiny_yolo": tiny_yolo,
    "fsrcnn": fsrcnn,
}
