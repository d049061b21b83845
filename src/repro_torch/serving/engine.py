"""Serving engine: model replicas behind Jiagu's control plane (port of
``repro.serving.engine``).

A *function* in Jiagu's terms is a model architecture; an *instance* is a
:class:`ServingInstance` — a replica holding weights and a slotted KV /
state cache, running continuous batching: each engine tick prefills newly
admitted requests into free slots and advances every active slot by one
decode step.  The :class:`ServingEngine` is the per-node data plane the
control plane (``core/``) schedules.

Differences from the reference, all from running eagerly on one device:

  * steps run eagerly; nothing replaces ``jax.jit``, so there is no
    per-function step cache;
  * the instance's slot cache is a list of torch tensors on its device.
    Admitting a request copies its one-row prefill cache into the slot's
    rows in place (``_splice_cache``), and decode writes each new token
    into the cache in place, which saves a copy of the whole cache per
    admit and per step;
  * ``use_kernel=False`` runs prefill through the kernels' plain PyTorch
    versions on the same device (the yardstick on the card);
  * a request also records ``t_admit``, when its prefill began, so the
    prefill time is ``t_first_token - t_admit``.

The saturated-load semantics match the paper: an instance serves at most
``slots`` concurrent requests; the autoscaler's saturated_rps maps to
slots/expected-latency.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.predictor import resolve_device
from ..models import model as model_lib


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int = 16
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    tokens: List[int] = field(default_factory=list)

    @property
    def latency_ms(self) -> float:
        return 1e3 * ((self.t_done or time.time()) - self.t_submit)


def _check_device(params, device) -> torch.device:
    """The instance's device (the card unless the caller names another);
    the parameters must already be there."""
    dev = resolve_device(device)
    have = model_lib.params_device(params)
    if have.type != dev.type or (dev.index is not None
                                 and have.index != dev.index):
        raise ValueError(f"parameters are on {have}, serving asked for "
                         f"{dev}")
    return have


class ServingInstance:
    """One replica: weights + a fixed-slot batched KV / state cache."""

    _ids = 0

    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_len: int = 512, device=None, use_kernel: bool = True):
        self.device = _check_device(params, device)
        ServingInstance._ids += 1
        self.iid = ServingInstance._ids
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.cache = model_lib.init_cache(cfg, slots, max_len, self.device)
        self.pos = np.zeros(slots, np.int64)
        self.active: List[Optional[Request]] = [None] * slots
        self.last_token = np.zeros(slots, np.int64)

    # -- slot management ---------------------------------------------------

    def free_slots(self) -> int:
        return sum(1 for r in self.active if r is None)

    def n_active(self) -> int:
        return self.slots - self.free_slots()

    def admit(self, req: Request) -> bool:
        """Prefill `req` into a free slot (one-request prefill, its cache
        rows copied into the batched cache)."""
        try:
            slot = self.active.index(None)
        except ValueError:
            return False
        req.t_admit = time.time()
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                               device=self.device)
        logits, cache1 = model_lib.prefill(self.cfg, self.params,
                                           {"tokens": toks}, self.max_len,
                                           use_kernel=self.use_kernel)
        tok0 = int(torch.argmax(logits[0]))
        req.tokens.append(tok0)
        req.t_first_token = time.time()
        _splice_cache(self.cache, cache1, slot)
        self.pos[slot] = len(req.prompt)
        self.last_token[slot] = tok0
        self.active[slot] = req
        return True

    def step(self) -> List[Request]:
        """One decode step over all slots; returns finished requests."""
        if self.n_active() == 0:
            return []
        toks = torch.from_numpy(self.last_token).to(self.device)
        pos = torch.from_numpy(self.pos).to(self.device)
        logits, self.cache = model_lib.decode_step(self.cfg, self.params,
                                                   toks, pos, self.cache)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        done = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.tokens.append(int(nxt[s]))
            self.pos[s] += 1
            self.last_token[s] = nxt[s]
            if len(req.tokens) >= req.max_new or self.pos[s] >= \
                    self.max_len - 1:
                req.t_done = time.time()
                done.append(req)
                self.active[s] = None
        return done


def _splice_cache(full, one, slot: int):
    """Copy the single-request cache `one` (batch 1) into row `slot` of
    the batched cache `full`, in place, layer by layer."""
    for f_layer, o_layer in zip(full, one):
        for key, o in o_layer.items():
            f_layer[key][slot: slot + 1].copy_(o)


class ServingEngine:
    """Per-function pool of instances + router with saturated/cached
    split (dual-staged scaling's data plane): requests go only to
    *saturated* instances; cached instances retain state but receive no
    traffic until a logical cold start re-labels them."""

    def __init__(self, cfg: ModelConfig, params, slots: int = 4,
                 max_len: int = 512, device=None, use_kernel: bool = True):
        self.device = _check_device(params, device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.instances: Dict[int, ServingInstance] = {}
        self.cached: set = set()          # iids drained by "release"
        self.queue: List[Request] = []
        self.done: List[Request] = []

    # -- control-plane hooks (called by the Jiagu autoscaler/scheduler) ----

    def scale_up(self, k: int = 1, init_delay_s: float = 0.0) -> List[int]:
        out = []
        for _ in range(k):
            inst = ServingInstance(self.cfg, self.params, self.slots,
                                   self.max_len, self.device,
                                   self.use_kernel)
            self.instances[inst.iid] = inst
            out.append(inst.iid)
        return out

    def release(self, k: int = 1) -> List[int]:
        """Drain k saturated instances (dual-staged stage 1)."""
        sat = [i for i in self.instances if i not in self.cached]
        picked = sat[:k]
        self.cached.update(picked)
        return picked

    def logical_start(self, k: int = 1) -> int:
        """Re-route to k cached instances (<1 ms; no init cost)."""
        revived = list(self.cached)[:k]
        for i in revived:
            self.cached.discard(i)
        return len(revived)

    def evict_cached(self, k: int = 1) -> int:
        victims = list(self.cached)[:k]
        for i in victims:
            self.cached.discard(i)
            self.instances.pop(i, None)
        return len(victims)

    def n_saturated(self) -> int:
        return len(self.instances) - len(self.cached)

    # -- data plane ---------------------------------------------------------

    def submit(self, req: Request):
        req.t_submit = time.time()
        self.queue.append(req)

    def tick(self):
        """Admit queued requests round-robin over saturated instances,
        then advance every instance one decode step."""
        sat = [inst for iid, inst in sorted(self.instances.items())
               if iid not in self.cached]
        if sat:
            while self.queue:
                order = sorted(sat, key=lambda i: -i.free_slots())
                if order[0].free_slots() == 0:
                    break
                order[0].admit(self.queue.pop(0))
        for inst in sat:
            self.done.extend(inst.step())

    def drain(self, max_ticks: int = 1000):
        for _ in range(max_ticks):
            if not self.queue and all(i.n_active() == 0
                                      for i in self.instances.values()):
                break
            self.tick()
        return self.done
