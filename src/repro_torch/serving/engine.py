"""Serving engine: model replicas behind Jiagu's control plane (port of
``repro.serving.engine``).

A *function* in Jiagu's terms is a model architecture; an *instance* is a
:class:`ServingInstance` — a replica holding weights and a slotted KV /
state cache, running continuous batching: each engine tick prefills newly
admitted requests into free slots and advances every active slot by one
decode step.  The :class:`ServingEngine` is the per-node data plane the
control plane (``core/``) schedules.

Differences from the reference, all from running on one device:

  * the reference jits decode and prefill once per function
    (``_jitted_steps``); here each instance's decode step is captured in
    a CUDA graph at its first ``step()`` on the card (``DecodeStep``),
    since a graph binds the addresses of the instance's own slot cache.
    What is shared per function (``_STEP_CACHE``) is the graphs' memory
    pool; every capture runs on one side stream.  Prefill runs
    eagerly: a graph binds one prompt length, where the reference
    compiles its prefill again for each new one;
  * the instance's slot cache is a list of torch tensors on its device.
    Admitting a request copies its one-row prefill cache into the slot's
    rows in place (``_splice_cache``), and decode writes each new token
    and state into the cache in place, which saves a copy of the whole
    cache per admit and per step and lets the captured step replay on
    the same tensors;
  * ``use_kernel=False`` runs prefill through the kernels' plain PyTorch
    versions on the same device (the yardstick on the card), and
    ``graph=False`` runs decode eagerly (the CPU always does);
  * a request also records ``t_admit``, when its prefill began, so the
    prefill time is ``t_first_token - t_admit``.

The saturated-load semantics match the paper: an instance serves at most
``slots`` concurrent requests; the autoscaler's saturated_rps maps to
slots/expected-latency.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.predictor import resolve_device
from ..kernels import _scratch
from ..models import model as model_lib


class _SharedStep:
    """The per-function part of the captured decode step, as the
    reference shares its jitted step between replicas: one CUDA graph
    memory pool for the graphs of the function's instances.  One pool
    serves them all because their replays are serial on the caller's
    stream and each replay's outputs are read before the next replay.
    Once every graph of the pool is gone the caching allocator frees the
    pool (at its next ``empty_cache``) and takes no capture into it, so
    the next capture opens a new one."""

    def __init__(self):
        self.pool = None
        self.graphs = weakref.WeakSet()

    def pool_for(self, graph: "torch.cuda.CUDAGraph"):
        """The pool `graph` is to be captured into."""
        if not self.graphs:
            self.pool = torch.cuda.graph_pool_handle()
        self.graphs.add(graph)
        return self.pool


#: per function, (cfg, slots, max_len, device) -> what its instances
#: share of their captured decode steps (``DecodeStep``)
_STEP_CACHE: Dict[tuple, _SharedStep] = {}
#: per device, the side stream every step is warmed up and captured on
#: (the decode steps and ``distributed.steps.TrainStep``): one for all
#: functions, so that cuBLAS keeps one workspace for them
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _shared_step(cfg: ModelConfig, slots: int, max_len: int,
                 device: torch.device) -> _SharedStep:
    key = (cfg, slots, max_len, device)
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = _SharedStep()
    return _STEP_CACHE[key]


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    # "cuda" and "cuda:0" name one card, and share its stream
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def warm_up(device: torch.device, run):
    """``run()`` on `device`'s capture stream with the CUDA sync debug
    mode at "error", so that a step that waits on the host raises here,
    before any capture; returns its result once the device has run it.
    The warm-up builds the kernels and readies the allocator, cuBLAS and
    the kernels' scratch on the stream the capture uses."""
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    mode = torch.cuda.get_sync_debug_mode()
    try:
        with torch.cuda.stream(stream):
            torch.cuda.set_sync_debug_mode("error")
            out = run()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream(device).wait_stream(stream)
    torch.cuda.synchronize(device)
    return out


def capture(device: torch.device, run, pool_for=None):
    """``run()`` captured in a CUDA graph on `device`'s capture stream ->
    (the graph, ``run()``'s outputs, the kernels' scratch buffers the
    graph must keep, the bytes the capture added to the memory reserved).
    The graph's memory pool is ``pool_for(graph)``, or a pool of its own.
    Nothing runs until the graph is replayed."""
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    pool = pool_for(graph) if pool_for else torch.cuda.graph_pool_handle()
    with torch.cuda.stream(_capture_stream(device)), \
            _scratch.held() as bufs:
        graph.capture_begin(pool=pool)
        try:
            out = run()
        finally:
            graph.capture_end()
    return graph, out, bufs, torch.cuda.memory_reserved(device) - reserved


class DecodeStep:
    """One instance's decode step over its slot cache.  It owns static
    device buffers for the tokens and positions it reads and for its
    outputs: ``logits`` (slots, V), ``pre`` (the logits before the
    model's final softcap; the same tensor where the model has none) and
    ``next`` (their argmax, which the host reads).  ``capture_ms`` is
    the host time of the warm-up and the capture, ``pool_bytes`` what the
    capture added to the memory reserved (the pool's new segments; none
    where it fits in what the function's earlier graphs left free).

    On the card with `graph`, the first call warms the step up once on
    the device's capture stream, then captures it in a CUDA graph
    (``torch.cuda.CUDAGraph``) into the function's pool
    (``_SharedStep``); every call replays the graph.  The warm-up writes
    copies of the recurrent and SSM states, which a step writes whole;
    its writes into the attention caches are the slot writes the first
    replay makes again.  It runs with the CUDA sync debug mode at
    "error", so a step that waits on the host raises there, before its
    capture.  A step that cannot be captured raises: it never falls back
    to eager.  On the CPU, or without `graph`, each call runs the step
    eagerly."""

    def __init__(self, cfg: ModelConfig, params, cache, slots: int,
                 max_len: int, device: torch.device, graph: bool = True):
        self.cfg, self.params, self.cache = cfg, params, cache
        self.slots, self.max_len, self.device = slots, max_len, device
        self.graphed = graph and device.type == "cuda"
        self.tokens = torch.zeros(slots, dtype=torch.int64, device=device)
        self.pos = torch.zeros(slots, dtype=torch.int64, device=device)
        self.logits = self.pre = self.next = None
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self._held: list = []       # the scratch buffers the graph keeps
        self.replays = 0
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def _run(self, cache):
        logits, pre = model_lib.decode_logits(self.cfg, self.params,
                                              self.tokens, self.pos, cache)
        return logits, pre, torch.argmax(logits, dim=-1)

    def _capture(self):
        shared = _shared_step(self.cfg, self.slots, self.max_len,
                              self.device)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        warm = [{k: t.clone() for k, t in c.items()}
                if spec.kind in ("recurrent", "ssm") else c
                for spec, c in zip(model_lib.layer_specs(self.cfg),
                                   self.cache)]
        warm_up(self.device, lambda: self._run(warm))
        del warm
        self.graph, out, self._held, self.pool_bytes = capture(
            self.device, lambda: self._run(self.cache), shared.pool_for)
        self.logits, self.pre, self.next = out
        self.capture_ms = 1e3 * (time.perf_counter() - t0)

    def __call__(self, last_token: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One step from each slot's last token and position (host int64
        arrays); returns each slot's next token on the host."""
        self.tokens.copy_(torch.from_numpy(last_token))
        self.pos.copy_(torch.from_numpy(pos))
        if not self.graphed:
            self.logits, self.pre, self.next = self._run(self.cache)
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
        return self.next.cpu().numpy()

    def close(self):
        """Drops the graph, the outputs it wrote into the pool and the
        scratch it kept (the graph is freed with the last reference to
        it)."""
        self.graph = self.logits = self.pre = self.next = None
        self._held = []


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
                 max_len: int = 512, device=None, use_kernel: bool = True,
                 graph: bool = True):
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
        self.decoder = DecodeStep(cfg, params, self.cache, slots, max_len,
                                  self.device, graph)

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
        nxt = self.decoder(self.last_token, self.pos)
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

    def close(self):
        """Frees the instance's captured decode step."""
        self.decoder.close()


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
                 max_len: int = 512, device=None, use_kernel: bool = True,
                 graph: bool = True):
        self.device = _check_device(params, device)
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.graph = graph
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
                                   self.use_kernel, self.graph)
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
            inst = self.instances.pop(i, None)
            if inst is not None:
                inst.close()
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
