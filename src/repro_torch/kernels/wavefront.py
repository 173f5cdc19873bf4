"""FCFS wavefront serialization: the wrappers of the CUDA kernels
`csrc/wavefront.cu`, which replace the JAX package's Pallas kernel
`repro/kernels/wavefront.py:serialize_prefix` and the jitted scan over
wavefronts around it (`repro/core/vectorized.py:BatchedFitness._score`).

`serialize_prefix` serializes one wavefront's queues; `wavefront_scan` runs
the GA prefilter's whole scan over wavefronts for a chunk of genomes in one
launch, a block per genome.  A CPU tensor goes to the plain version
(`repro_torch.kernels.ref`); a CUDA tensor goes to the kernel, or the
wrapper raises.  Each wrapper's `.launches` counts its kernel's launches,
and nothing else.

`scan_route` says, from shapes alone and before any launch, which of the two
a CUDA fitness call takes: "fused" (`wavefront_scan`) where a wavefront fits
one warp and a genome's state fits a block's shared memory, "step" (a loop
over wavefronts with a `serialize_prefix` launch per queue update) for any
other graph.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import (SMEM_LIMIT, check, cuda_index,
                                       load_library, stream_of)
from repro_torch.kernels.ref import (SEGMENTS, population_last,
                                     serialize_prefix_ref,
                                     wavefront_scan_ref)

MAX_WIDTH = 32          # a wavefront's slots are the lanes of one warp
STAGES = 4              # csrc/wavefront.cu: kStages, the ring of inputs


def serialize_prefix(free0: torch.Tensor, release: torch.Tensor,
                     dur: torch.Tensor):
    """``free0``: (..., R); ``release``/``dur``: (..., R, W) float32 ->
    ``(finish (..., R, W), new_free (..., R))``.  Leading axes are flattened
    to queue rows.  On CUDA the three inputs must be contiguous float32 on one
    device (the kernel reads (rows, W) row-major)."""
    if release.shape != dur.shape or release.shape[:-1] != free0.shape:
        raise ValueError(
            f"shapes disagree: free0 {tuple(free0.shape)}, release "
            f"{tuple(release.shape)}, dur {tuple(dur.shape)}")
    if release.shape[-1] == 0:
        raise ValueError("serialize_prefix needs at least one item per row")
    index = cuda_index(free0, release, dur)
    if index < 0:
        return serialize_prefix_ref(free0, release, dur)
    for name, t in (("free0", free0), ("release", release), ("dur", dur)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    w = release.shape[-1]
    rows = release.numel() // w
    fin = torch.empty_like(release)
    new_free = torch.empty_like(free0)
    if rows == 0:
        return fin, new_free
    lib = load_library("wavefront")
    code = lib.launch(
        free0.data_ptr(), release.data_ptr(), dur.data_ptr(), fin.data_ptr(),
        new_free.data_ptr(), rows, w, index, stream_of(index))
    check(lib, code, "serialize_prefix")
    serialize_prefix.launches += 1
    return fin, new_free


serialize_prefix.launches = 0


def _round4(words: int) -> int:
    return -(-words // 4) * 4


def record_layout(width: int, n_cores: int, n_chan: int, dmax: int,
                  comm: bool = True, spills: bool = True) -> dict:
    """Offsets, in 4-byte words, of the kernel's two records of a wavefront
    (`csrc/wavefront.cu:record_layout`), and their lengths "words" and
    "static_words", each padded to 16 bytes.  A genome's record: each
    slot's cycles ("cyc") and core ("cw"); with the spill model each slot's
    allocated bytes ("aw") and memory core ("mw") and each core's allocated
    and freed bytes ("ac", "fc"); with channel transfers each channel's
    occupancy of each slot ("occ") and the (W, D) crossing flags as bytes
    ("cross").  The static record: each slot's CN ("wf", n for a pad slot),
    layer ("wl") and DRAM end offset ("dram"), the DRAM port's busy time
    ("tot") and each slot's predecessors ("pu")."""
    W, C, H, D = width, n_cores, n_chan, dmax
    sizes = (("cyc", W), ("cw", W), ("aw", W * spills), ("mw", W * spills),
             ("ac", C * spills), ("fc", C * spills), ("occ", H * W * comm),
             ("cross", -(-W * D // 4) * comm))
    out, t = {}, 0
    for key, size in sizes:
        out[key], t = t, t + size
    out["words"] = _round4(t)
    t = 0
    for key, size in (("wf", W), ("wl", W), ("dram", W), ("tot", 1),
                      ("pu", W * D)):
        out[key], t = t, t + size
    out["static_words"] = _round4(t)
    return out


def smem_bytes(n: int, width: int, n_cores: int, n_chan: int, n_seg: int,
               dmax: int, comm: bool = True, spills: bool = True) -> int:
    """Shared memory of one `wavefront_scan` block, as
    `csrc/wavefront.cu:scan_layout`: the genome's state (finish and spilled
    per CN, the segment frontiers, the queues' free times, occupancy) and a
    ring of `STAGES` stages, each a wavefront's two records."""
    state = 2 * (n + 1) + 5 * n_seg + 7 * n_cores + max(n_chan, 1) \
        + MAX_WIDTH * (n_chan + 2) + 2
    r = record_layout(width, n_cores, n_chan, dmax, comm, spills)
    return 4 * (_round4(state) + STAGES * (r["words"] + r["static_words"]))


def scan_route(n: int, width: int, n_cores: int, n_chan: int, n_seg: int,
               dmax: int) -> str:
    """"fused" when a CUDA fitness call runs its scan as one
    `wavefront_scan` launch: every wavefront fits one warp (`width` <= 32)
    and a genome's block fits the shared memory a block may use (with
    channel transfers and the spill model, its most); "step" (the loop over
    wavefronts with the `serialize_prefix` kernel) otherwise."""
    if width > MAX_WIDTH:
        return "step"
    if smem_bytes(n, width, n_cores, n_chan, n_seg, dmax) > SMEM_LIMIT:
        return "step"
    return "fused"


def pack(genomes: torch.Tensor, xs: dict, st: dict) -> dict:
    """The kernel's inputs from `wavefront_scan`'s: "rec" (P, L, words), a
    genome's record of each wavefront, genome-major and contiguous (a
    genome's whole scan is one block's contiguous rows); "srec" (L,
    static_words), the static record of each wavefront (see
    `record_layout`); indices as int32 and the crossing flags as bytes,
    each in the float32 words' storage; "genomes" as int32; the per-core and
    per-layer tables as float32.  Padding words are left unwritten."""
    L, W, P = xs["cyc"].shape
    C = st["w_cap"].shape[0]
    D = st["pu"].shape[2] if "pu" in st else 0
    comm, spills = "cross" in xs, "ac" in xs
    H = xs["occ"].shape[1] if comm else 0
    r = record_layout(W, C, H, D, comm, spills)
    dev = genomes.device
    rec = torch.empty((P, L, r["words"]), dtype=torch.float32, device=dev)
    srec = torch.empty((L, r["static_words"]), dtype=torch.float32,
                       device=dev)
    words = {torch.float32: rec, torch.int32: rec.view(torch.int32)}
    static = {torch.float32: srec, torch.int32: srec.view(torch.int32)}

    def put(key, dtype):    # a population-last (L, ..., P) input, one copy
        src = xs[key].movedim(-1, 0)                 # (P, L, ...)
        size = math.prod(src.shape[2:])
        dst = words[dtype][:, :, r[key]:r[key] + size]
        dst.unflatten(2, src.shape[2:]).copy_(src)

    put("cyc", torch.float32)
    put("cw", torch.int32)
    if spills:
        for key in ("aw", "ac", "fc"):
            put(key, torch.float32)
        put("mw", torch.int32)
    if comm:
        put("occ", torch.float32)
        o = 4 * r["cross"]
        rec.view(torch.uint8)[:, :, o:o + W * D].unflatten(2, (W, D)).copy_(
            xs["cross"].permute(3, 0, 1, 2))
    for key, dtype in (("wf", torch.int32), ("wf_layer", torch.int32),
                       ("dram", torch.float32)):
        o = r["wl" if key == "wf_layer" else key]
        static[dtype][:, o:o + W].copy_(st[key])
    srec[:, r["tot"]].copy_(st["tot"])
    if D:
        o = r["pu"]
        static[torch.int32][:, o:o + W * D].unflatten(1, (W, D)).copy_(
            st["pu"])
    out = {"genomes": genomes.to(torch.int32).contiguous(), "rec": rec,
           "srec": srec}
    for key in ("act_cap", "layer_wb", "w_cap"):
        out[key] = st[key].to(torch.float32).contiguous()
    return out


_FLOATS = ("cyc", "occ", "aw", "ac", "fc", "sc", "dram", "tot", "act_cap",
           "layer_wb", "w_cap")
_MASKS = ("on", "cross", "member")


def _check_types(genomes: torch.Tensor, xs: dict, st: dict) -> None:
    """Raise unless the scan's inputs have the types `BatchedFitness`
    hoists: float32 times, bytes and capacities, boolean masks, integer
    cores, CNs, layers and predecessors."""
    for name, t in (("genomes", genomes), *xs.items(), *st.items()):
        if name in _FLOATS:
            ok = t.dtype == torch.float32
        elif name in _MASKS:
            ok = t.dtype == torch.bool
        else:
            ok = not t.dtype.is_floating_point and t.dtype != torch.bool
        if not ok:
            raise TypeError(f"{name} has the wrong type {t.dtype}")


def wavefront_scan(genomes: torch.Tensor, xs: dict, st: dict, *, n: int,
                   n_chan: int, segment: str = "greedy"):
    """The GA prefilter's scan over wavefronts under FCFS serialization, for
    one chunk of genomes: `repro_torch.kernels.ref.wavefront_scan_ref` with
    `serialize_prefix_ref` (see there for the arguments and the population-
    last results).  On CUDA one launch scores the chunk; the graph must
    take the fused route (`scan_route`), and the backlog model ("sc" in
    `xs`) has no kernel."""
    if segment not in SEGMENTS:
        raise ValueError(f"unknown segment mode {segment!r}")
    _check_types(genomes, xs, st)
    index = cuda_index(genomes, *xs.values(), *st.values())
    if index < 0:
        return wavefront_scan_ref(genomes, xs, st, n=n, n_chan=n_chan,
                                  segment=segment,
                                  serialize=population_last(
                                      serialize_prefix_ref))
    if "on" not in xs:
        raise ValueError("wavefront_scan runs FCFS serialization: xs needs "
                         "the slot-on-core masks 'on'")
    L, W, P = xs["cyc"].shape
    C = st["w_cap"].shape[0]
    G = genomes.shape[1]
    D = st["pu"].shape[2] if "pu" in st else 0
    if genomes.shape[0] != P or tuple(st["wf"].shape) != (L, W):
        raise ValueError(f"shapes disagree: genomes {tuple(genomes.shape)}, "
                         f"cyc {tuple(xs['cyc'].shape)}, wf "
                         f"{tuple(st['wf'].shape)}")
    if "cross" in xs and tuple(xs["occ"].shape) != (L, n_chan, W, P):
        raise ValueError(f"occ {tuple(xs['occ'].shape)} is not "
                         f"{(L, n_chan, W, P)}")
    if scan_route(n, W, C, n_chan, G, D) != "fused":
        raise ValueError(f"width {W} or n {n} takes the step route: "
                         f"wavefront_scan runs at most {MAX_WIDTH} slots and "
                         f"{SMEM_LIMIT} bytes of shared memory")
    k = pack(genomes, xs, st)
    dev = genomes.device
    finish = torch.empty((n + 1, P), dtype=torch.float32, device=dev)
    spilled = torch.empty_like(finish)
    core_free = torch.empty((C, P), dtype=torch.float32, device=dev)
    chan_free = torch.empty((max(n_chan, 1), P), dtype=torch.float32,
                            device=dev)
    dram_free = torch.empty(P, dtype=torch.float32, device=dev)
    dram_x = torch.empty_like(dram_free)
    flags = (int("cross" in xs) | int("ac" in xs) << 1
             | SEGMENTS.index(segment) << 2)
    lib = load_library("wavefront")
    code = lib.launch_scan(
        k["genomes"].data_ptr(), k["rec"].data_ptr(), k["srec"].data_ptr(),
        k["act_cap"].data_ptr(), k["layer_wb"].data_ptr(),
        k["w_cap"].data_ptr(), finish.data_ptr(), core_free.data_ptr(),
        chan_free.data_ptr(), dram_free.data_ptr(), spilled.data_ptr(),
        dram_x.data_ptr(), P, n, L, W, D, C, n_chan, G, k["rec"].shape[2],
        k["srec"].shape[1], flags, index, stream_of(index))
    check(lib, code, "wavefront_scan")
    wavefront_scan.launches += 1
    return finish, core_free, chan_free, dram_free, spilled, dram_x


wavefront_scan.launches = 0
