"""Batched serving engine: continuous prefill + decode over a KV cache (the
JAX package's `repro/serve/engine.py` over the port's models).

A deliberately compact vLLM-style loop: requests are admitted into a fixed
batch of slots; prefill fills a slot's cache region; every engine step
decodes one token for all active slots. Caches live on the device and are
written in place (the reference donates them to its jitted programs).

Admission is delegated to `repro_torch.serve.batching.SlotBatcher`, the
same policy object the reference's analytic simulator drives.  One
engine-specific restriction: the KV cache shares a single sequence clock
(`cur_len`, a Python int) across slots, so `serve` admits in FIFO waves
(newcomers enter when the current cohort has fully drained) rather than
per-step.

`device=None` means CUDA and raises without it.  `kernels=None` runs the
hand-written CUDA kernels on the card and the plain model math on the CPU
(see `repro_torch.models.zoo`).  Each step reads the sampled tokens back
once (`tolist()`), the engine's only host sync.

`mesh` (a `sharding.rules.Mesh`, or None for one device, where the
reference always takes one): the engine keeps this rank's blocks of the
weights (`transformer.param_shardings`) and of the caches
(`zoo.cache_shardings`); every rank builds the same prompts and samples
the same tokens from the whole logits.  On a mesh of one rank the blocks
are the whole tensors and every step is the mesh-free engine's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.vectorized import resolve_device
from repro_torch.models import zoo
from repro_torch.models.module import init_from_specs
from repro_torch.models.transformer import param_shardings, resolve_kernels
from repro_torch.sharding.rules import local_specs, shard_tree
from repro_torch.serve.batching import SlotBatcher


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) token ids
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, *, mesh=None,
                 batch_slots: int = 4, max_len: int = 512,
                 prompt_len: int = 64, device=None, kernels=None):
        dev = resolve_device(device)
        self.device = params["embed"].device
        if self.device.type != dev.type or dev.index not in (
                None, self.device.index):
            raise ValueError(f"params lie on {self.device}, not on {dev}")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            params = shard_tree(params, param_shardings(cfg, mesh))
        self.params = params
        self.kernels = resolve_kernels(kernels, self.device)
        self.B = batch_slots
        self.max_len = max_len
        self.prompt_len = prompt_len
        if self.device.type == "cuda":
            # float32 products (an f32 config, the plain logits) stay float32
            torch.backends.cuda.matmul.allow_tf32 = False
        cspecs = zoo.build_cache_specs(cfg, batch_slots, max_len)
        if mesh is not None:
            cspecs = local_specs(cspecs, zoo.cache_shardings(
                cfg, batch_slots, max_len, mesh))
        self.caches = init_from_specs(cspecs, 0, device=self.device)
        self.cur_len = 0

    # ---- step methods -------------------------------------------------
    def prefill_step(self, requests: list[Request]):
        """Batched prefill for up to `batch_slots` requests: fills each
        slot's cache region, resets the sequence clock to `prompt_len`,
        and returns the first greedily sampled token per slot."""
        if len(requests) > self.B:
            raise ValueError(f"{len(requests)} requests for {self.B} slots")
        S = self.prompt_len
        prompts = np.zeros((self.B, S), np.int64)
        for i, r in enumerate(requests):
            p = np.asarray(r.prompt)[-S:]
            prompts[i, S - len(p):] = p
        tokens = torch.as_tensor(prompts, device=self.device)
        logits, self.caches = zoo.prefill(self.cfg, self.params,
                                          {"tokens": tokens}, self.caches,
                                          mesh=self.mesh,
                                          kernels=self.kernels)
        self.cur_len = S
        return torch.argmax(logits, dim=-1)

    def decode_once(self, tok):
        """One decode step for every slot: consumes the previous token
        per slot, advances the shared sequence clock, returns the next
        greedily sampled token per slot."""
        logits, self.caches = zoo.decode_step(
            self.cfg, self.params, tok[:, None], self.caches, self.cur_len,
            mesh=self.mesh, kernels=self.kernels)
        self.cur_len += 1
        return torch.argmax(logits, dim=-1)

    # ------------------------------------------------------------------
    def run(self, requests: list[Request]):
        """Serve a batch of requests to completion (batched prefill+decode)."""
        tok = self.prefill_step(requests)
        max_new = max(r.max_new_tokens for r in requests)
        for _ in range(max_new):
            host = tok.tolist()
            for i, r in enumerate(requests):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(host[i])
            tok = self.decode_once(tok)
        for r in requests:
            r.done = True
        return requests

    def serve(self, requests: list[Request]):
        """Serve arbitrarily many requests through the slot pool.

        FIFO admission through a `SlotBatcher`: up to `batch_slots`
        requests form a wave (one batched prefill), each drains its slot
        when it reaches `max_new_tokens`, and the next wave is admitted
        once the cohort is empty (shared-clock restriction, see module
        docstring).  Tokens are identical to `run` on each wave.
        """
        batcher = SlotBatcher(self.B)
        queue = list(range(len(requests)))
        while queue:
            n_admit = min(batcher.free_slots(), len(queue))
            cohort = [queue.pop(0) for _ in range(n_admit)]
            for rid in cohort:
                batcher.admit(rid)
            tok = self.prefill_step([requests[rid] for rid in cohort])
            while batcher.active():
                host = tok.tolist()
                for slot, rid in enumerate(cohort):
                    r = requests[rid]
                    if r.done:
                        continue
                    r.out_tokens.append(host[slot])
                    if len(r.out_tokens) >= r.max_new_tokens:
                        r.done = True
                        batcher.release(rid)
                if batcher.active():
                    tok = self.decode_once(tok)
        self.max_active = batcher.max_active
        return requests
