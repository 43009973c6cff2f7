"""Batched serving engine: a continuous-batching request scheduler over the
model's prefill/decode API (the port of ``repro/serving/engine.py``).

  * A fixed decode batch of ``max_batch`` slots; the cache is allocated
    ONCE at [B = max_batch, S = max_len] (batch is dim 1 of every cache
    leaf), each leaf in its own dtype (``ModelAPI.cache_specs`` at the
    parameters' dtype: K/V bf16, the SSM and wkv states f32, the conv and
    token-shift rows bf16 for bf16 weights). Decode writes every leaf in
    place, in its dtype.
  * Admission: each new request is prefilled alone (batch 1, one
    full-sequence pass) and its cache is written into its slot along dim 1
    of every leaf, rounded to the cache dtype.
  * Generation: ONE batched decode step advances every active slot per tick,
    each at its own cursor (a per-slot position vector). Parked slots
    decode at position ``max_len - 1``, which the next admission
    overwrites.
  * Finished slots (EOS or length cap) free at once and are refilled from
    the queue on the next tick.

Logits come back to the host for sampling, once per prefill and once per
tick. Over a model axis (``get_model(tp_size=M)``) every rank runs the
engine on the same requests: prefill and decode return the logits
gathered whole, greedy takes their argmax (the lowest index on ties) and
top-p draws from the CPU generator seeded alike on every rank, so every
rank emits the same tokens. The encoder-decoder family is refused, as the reference refuses it:
each request needs its own encoder memory; drive it through the ModelAPI's
prefill and decode.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import ModelAPI

from .sampling import greedy

#: why the engine refuses the encoder-decoder family
ENCDEC_NOT_SERVED = ("enc-dec serving needs per-request encoder memory; "
                     "the engine serves decoder-only families: drive an "
                     "encdec model through its ModelAPI prefill/decode")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8           # decode slots
    max_len: int = 256           # cache capacity per slot
    eos_token: int = 2
    max_new_tokens: int = 64


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # [S] int32
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Continuous batching over ModelAPI prefill/decode (decoder-only).

    ``device`` (``None``: the GPU, raising without one) must be the
    model's; ``generator`` (CPU, seed 0 by default) feeds the sampler."""

    def __init__(self, api: ModelAPI, params, cfg: ServeConfig, *,
                 sampler: Callable[..., torch.Tensor] = greedy,
                 generator: Optional[torch.Generator] = None, device=None):
        if api.cfg.family == "encdec":
            raise ValueError(ENCDEC_NOT_SERVED)
        dev = resolve_device(device)
        if dev != api.device:
            raise ValueError(f"the engine runs on {dev} but the model on "
                             f"{api.device}")
        self.api = api
        self.params = params
        self.cfg = cfg
        self.sampler = sampler
        self.generator = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.device = dev

        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * cfg.max_batch
        self.slot_pos = np.zeros(cfg.max_batch, np.int64)
        self._cache = None
        self._uid = 0
        self.ticks = 0

    # ------------------------------------------------------------------ api

    def submit(self, prompt) -> int:
        self._uid += 1
        self.queue.append(Request(self._uid, np.asarray(prompt, np.int32)))
        return self._uid

    def run(self) -> dict:
        """Drive everything to completion; returns {uid: generated tokens}."""
        results: dict = {}
        while self.queue or any(s is not None for s in self.slots):
            self._admit()
            self._decode_tick()
            for i, req in enumerate(self.slots):
                if req is not None and req.done:
                    results[req.uid] = list(req.out_tokens)
                    self.slots[i] = None
        return results

    # ------------------------------------------------------------ internals

    def _fresh_cache(self) -> dict:
        shape = ShapeConfig(f"serve_{self.cfg.max_len}", "decode",
                            self.cfg.max_len, self.cfg.max_batch)
        specs = self.api.cache_specs(shape, self.params["embed"].dtype)
        return {name: torch.zeros(s, dtype=dt, device=self.device)
                for name, (s, dt) in specs.items()}

    def _admit(self):
        """Prefill queued requests into free slots (batch-1 prefill, then a
        write into dim 1 of every leaf of the shared cache)."""
        if self._cache is None:
            self._cache = self._fresh_cache()
        for i in range(self.cfg.max_batch):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            prompt = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                     device=self.device)          # [1, S]
            cache1, logits1 = self.api.prefill(
                self.params, {"tokens": prompt}, max_len=self.cfg.max_len)
            for name, big in self._cache.items():     # f32 states stay f32
                big[:, i] = cache1[name][:, 0].to(big.dtype)
            self.slots[i] = req
            self.slot_pos[i] = len(req.prompt)
            self._sample_and_record(i, logits1[0].cpu())

    def _decode_tick(self):
        """One batched decode step for ALL active slots, each at its own
        cursor (per-slot position vector)."""
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and not r.done]
        if not active:
            return
        b = self.cfg.max_batch
        tokens = np.zeros(b, np.int64)
        # parked slots decode at the last position: they write K/V into
        # the last cache row and advance their recurrent states (SSM, conv,
        # wkv, token shift) from whatever the slot holds, so those states
        # are garbage until the slot is admitted again; admission rewrites
        # every leaf of the whole slot, so the scratch writes are harmless.
        pos = np.full(b, self.cfg.max_len - 1, np.int64)
        for i in active:
            tokens[i] = self.slots[i].out_tokens[-1]
            pos[i] = self.slot_pos[i]
        logits, self._cache = self.api.decode(
            self.params, self._cache,
            torch.as_tensor(tokens, device=self.device),
            torch.as_tensor(pos, device=self.device))
        self.ticks += 1
        logits = logits.cpu()
        for i in active:
            self.slot_pos[i] += 1
            self._sample_and_record(i, logits[i])

    def _sample_and_record(self, slot: int, logits: torch.Tensor):
        req = self.slots[slot]
        tok = int(self.sampler(logits[None, :], self.generator)[0])
        req.out_tokens.append(tok)
        if (tok == self.cfg.eos_token
                or len(req.out_tokens) >= self.cfg.max_new_tokens
                or int(self.slot_pos[slot]) >= self.cfg.max_len - 1):
            req.done = True
