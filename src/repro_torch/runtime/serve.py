"""Serving through the ACS window: a live session server + batch baseline
(PyTorch port of ``repro/runtime/serve.py``).

Each request owns a KV-cache slot and emits kernels exactly like the
paper's applications:

* ``prefill(slot)``  — one task per newly admitted request; reads the
  token buffer, writes that slot's cache buffer.
* ``decode(slots)``  — one task over the currently decodable slot set;
  reads and writes those slots' caches.

Because slots are disjoint buffers, the ACS window discovers that a new
request's prefill is independent of the in-flight decode and co-schedules
them — continuous batching *emerges from dependency scheduling* rather
than being hand-coded. A slot's prefill -> decode -> decode chain stays
serialized by its RAW hazards on the slot buffer.

Two servers share the slot/admission machinery (:class:`_ServingCore`):

* :class:`SessionServer` — the open-loop runtime. It owns a persistent
  session (the async :class:`~..core.frontier.FrontierSession`, a
  :class:`~..core.session.WaveSession`, the device window's
  :class:`~..core.device_dispatch.DeviceSession` or its mesh-sharded
  :class:`~..core.mesh_session.MeshDeviceSession`); admission emits a request's
  *whole program* (prefill + its count-bounded per-slot decode chain)
  through a live per-request ``TaskStream`` into the live window while
  other requests' chains are still in flight; per-task retirement
  callbacks harvest tokens and free prompt buffers without ever draining
  the world.
* :class:`ContinuousBatchingServer` — the per-step batch-drain baseline
  (``step()`` rebuilds a stream and blocks the host each iteration).

Both apply multi-tenant QoS admission: requests carry a priority class
(lower = more urgent) and an optional relative deadline; tenants may have
hard slot quotas and weighted shares. ``_pick_next`` orders the queue by
(aged effective priority, weighted tenant load, deadline, arrival) — with
the defaults this reduces exactly to fewest active slots, oldest first.
Aging promotes a waiting request one bucket per ``aging_s`` seconds.
Backpressure is a bounded admission FIFO (``submit`` raises
:class:`AdmissionQueueFull` at capacity and stamps the observed queue depth
on the request), and both servers free each request's prompt buffer once
its prefill has retired.

:class:`SessionServer` can additionally preempt long decode chains
cooperatively (``preempt_rounds``): chains are emitted in bounded
segments, and at each segment boundary a chain yields its slot to a
strictly more urgent queued request, parking its opaque ``(cache, token,
pos)`` slot state and resuming later from exactly where it left off.

Slot values are ``(cache, token, pos)`` tuples of tensors on the server's
device (the pool holds them as opaque values). A decode step never reads
the device from the host; harvesting a token does (``int(tok[0])``), once
per decode: that read is the serving loop's input dependence, and
``host_reads`` counts it with every other host read of a device value.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from ..core import BufferPool, TaskStream, WaveScheduler
from ..core.buffers import DeviceLike
from ..core.executors import SerialExecutor
from ..core.device_dispatch import DeviceSession
from ..core.frontier import FrontierSession
from ..core.mesh_session import MeshDeviceSession
from ..core.session import WaveSession
from ..core.wrapper import AcsKernel
from ..models import LanguageModel, decode_step, init_cache, prefill
from ..models.config import ArchConfig

__all__ = ["Request", "AdmissionQueueFull", "DrainTimeout",
           "ContinuousBatchingServer", "SessionServer",
           "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_LOW"]

_rid = itertools.count()

# QoS priority classes (lower = more urgent). Any non-negative int is a
# valid class; these three are the conventional named tiers.
PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2


class AdmissionQueueFull(RuntimeError):
    """submit() refused: the bounded admission FIFO is at capacity — the
    server's backpressure signal to producers."""


class DrainTimeout(RuntimeError):
    """``run_until_drained`` exhausted ``max_iters`` with work still
    queued or active. Carries the stuck state so operators see *what*
    stalled instead of a silently truncated result list."""

    def __init__(self, message: str, *, queue_depth: int, active_slots: int,
                 finished: Optional[List["Request"]] = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.active_slots = active_slots
        # requests that DID finish before the stall — not lost with the raise
        self.finished = finished or []


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # [S] int32
    max_new: int = 8
    tenant: str = "default"
    priority: int = PRIORITY_NORMAL     # QoS class, lower = more urgent
    deadline: Optional[float] = None    # SLO: seconds after arrival, or None
    rid: int = dataclasses.field(default_factory=lambda: next(_rid))
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    t_arrival: float = 0.0              # perf_counter at submit
    t_admit: float = 0.0                # perf_counter when a slot was granted
    t_finish: float = 0.0               # perf_counter when the last token retired
    queue_depth: int = 0                # admission FIFO depth observed at submit
    preemptions: int = 0                # times this request's chain was parked
    rounds_left: int = 0                # decode rounds not yet emitted/retired
    parked_state: Optional[tuple] = None  # opaque (cache, tok, pos) while parked

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new

    @property
    def finished(self) -> bool:
        """True once the request's last token has retired (``t_finish``
        is stamped exactly once, at finish)."""
        return self.t_finish > 0.0

    @property
    def latency(self) -> Optional[float]:
        """End-to-end request latency, or None until finished."""
        if not self.finished:
            return None
        return self.t_finish - self.t_arrival


class _ServingCore:
    """Slots, kernels, and QoS bounded admission — shared by both servers.

    QoS knobs (all default to the plain fairness rule):

    * ``tenant_weights`` — weighted shares: a tenant's load for admission
      purposes is ``active_slots / weight``.
    * ``tenant_quota`` — hard cap on a tenant's concurrently active
      slots; an int applies to every tenant, a dict caps only the listed
      tenants. Quota'd-out requests stay queued (never dropped).
    * ``aging_s`` — starvation bound: a queued request's *effective*
      priority improves one bucket per ``aging_s`` seconds waited
      (clamped at ``PRIORITY_HIGH``). ``None`` disables.
    """

    def __init__(self, cfg: ArchConfig, params: LanguageModel, *, max_slots: int = 4,
                 max_len: int = 64, max_queue: int = 256,
                 history_limit: Optional[int] = 1024,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quota: Optional[Union[int, Dict[str, int]]] = None,
                 aging_s: Optional[float] = 5.0,
                 device: DeviceLike = "cuda"):
        if cfg.frontend is not None:  # the reference's rule
            raise ValueError(f"{cfg.name}: the servers take token models; a frontend arch "
                             f"({cfg.frontend}) runs through forward, prefill and decode_step")
        self.pool = BufferPool(device)
        self.device = self.pool.device
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.max_queue = max_queue
        self.history_limit = history_limit
        self.tenant_weights = dict(tenant_weights or {})
        for t, w in self.tenant_weights.items():
            if not w > 0:
                raise ValueError(f"tenant weight must be > 0: {t!r} -> {w}")
        self.tenant_quota = tenant_quota
        if aging_s is not None and not aging_s > 0:
            raise ValueError(f"aging_s must be > 0 or None, got {aging_s}")
        self.aging_s = aging_s
        self.preemptions = 0  # chains parked at a segment boundary (server-wide)
        # Host reads of device values (harvested tokens, slot positions).
        self.host_reads = 0
        self.queue: Deque[Request] = collections.deque()
        self.active: Dict[int, Request] = {}
        # Incremental per-tenant active-slot counts, maintained at
        # _grant_slot / _release_slot.
        self._tenant_active: Dict[str, int] = {}
        # Rolling report trace: a long-lived server's host memory stays flat.
        self.report_log: Deque[Dict] = collections.deque(maxlen=history_limit)

        # one opaque buffer per slot: value = (cache, last_token, pos)
        self.slots = []
        for i in range(max_slots):
            cache = init_cache(cfg, 1, max_len, device=self.device)
            buf = self.pool.alloc((1,), np.float32, name=f"slot{i}",
                                  value=(cache, None, 0))
            self.slots.append(buf)
        self.free = list(range(max_slots))

        # The kernels close over the model, not the server: a closure over
        # ``self`` would be a reference cycle that keeps a deleted server's
        # model and slot caches on the card until the garbage collector runs.
        cfg_ = cfg

        def _prefill_fn(slot_val, tokens):
            cache, _, _ = slot_val
            logits, cache = prefill(params, cfg_, tokens, cache)
            tok = torch.argmax(logits[:, -1, : cfg_.vocab], dim=-1).to(torch.int32)
            pos = torch.full((), tokens.shape[1], dtype=torch.int32, device=tokens.device)
            # list-of-one: each element maps to one output buffer
            return [(cache, tok, pos)]

        def _decode_fn(*slot_vals):
            outs = []
            for cache, tok, pos in slot_vals:
                logits, cache = decode_step(params, cfg_, tok[:, None], cache, pos)
                nxt = torch.argmax(logits[:, -1, : cfg_.vocab], dim=-1).to(torch.int32)
                outs.append((cache, nxt, pos + 1))
            return outs

        self._prefill_kernel = AcsKernel(name="req_prefill", fn=_prefill_fn)
        self._decode_kernel = AcsKernel(name="req_decode", fn=_decode_fn)

    def _read_int(self, value: Any) -> int:
        """A slot's token or position as a host int; a device tensor costs
        one host read (counted)."""
        if isinstance(value, torch.Tensor):
            self.host_reads += 1
            return int(value.reshape(-1)[0])
        return int(value)

    # -- client API ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int = 8,
               tenant: str = "default", priority: int = PRIORITY_NORMAL,
               deadline: Optional[float] = None) -> Request:
        """Enqueue a request. Raises :class:`AdmissionQueueFull` when the
        bounded FIFO is at capacity and :class:`ValueError` for requests
        that can never be served (over-long prompt, negative ``max_new``,
        negative ``priority``, non-positive ``deadline``); otherwise
        stamps the observed queue depth on the request. ``max_new=0``
        means zero decode rounds."""
        if len(self.queue) >= self.max_queue:
            raise AdmissionQueueFull(
                f"admission queue at capacity ({self.max_queue}); retry later")
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the cache capacity "
                f"(max_len - 1 = {self.max_len - 1}); truncate the prompt "
                "or raise max_len")
        if max_new < 0:
            raise ValueError(f"max_new must be >= 0, got {max_new}")
        if priority < 0:
            raise ValueError(f"priority must be >= 0, got {priority}")
        if deadline is not None and not deadline > 0:
            raise ValueError(f"deadline must be > 0 seconds, got {deadline}")
        req = Request(prompt=prompt, max_new=max_new, tenant=tenant,
                      priority=priority, deadline=deadline)
        req.t_arrival = time.perf_counter()
        self.queue.append(req)
        req.queue_depth = len(self.queue)
        return req

    def queue_depth(self) -> int:
        return len(self.queue)

    # -- admission ----------------------------------------------------------
    def _quota_of(self, tenant: str) -> Optional[int]:
        if self.tenant_quota is None:
            return None
        if isinstance(self.tenant_quota, dict):
            return self.tenant_quota.get(tenant)
        return self.tenant_quota

    def _weight_of(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, 1.0)

    def effective_priority(self, req: Request,
                           now: Optional[float] = None) -> int:
        """The request's priority bucket *as scheduled*: the submitted
        class, improved one bucket per ``aging_s`` seconds waited,
        promoted to the top bucket once half its deadline budget is
        spent, clamped at :data:`PRIORITY_HIGH`."""
        if now is None:
            now = time.perf_counter()
        bucket = req.priority
        if self.aging_s is not None:
            bucket -= int((now - req.t_arrival) / self.aging_s)
        if req.deadline is not None:
            slack = (req.t_arrival + req.deadline) - now
            if slack <= 0.5 * req.deadline:
                bucket = PRIORITY_HIGH
        return max(bucket, PRIORITY_HIGH)

    def _admission_key(self, req: Request, now: float):
        """Total admission order: most urgent effective bucket, then
        least weighted tenant load, then earliest absolute deadline,
        then arrival order (rid)."""
        deadline_at = (req.t_arrival + req.deadline
                       if req.deadline is not None else float("inf"))
        load = self._tenant_active.get(req.tenant, 0) / self._weight_of(req.tenant)
        return (self.effective_priority(req, now), load, deadline_at, req.rid)

    def _pick_next(self) -> Optional[Request]:
        """QoS admission: pop the queued request minimizing
        :meth:`_admission_key`, skipping tenants at their quota. Returns
        None when every queued request is quota-blocked. Under cooperative
        preemption it also holds back requests strictly less urgent than
        the most urgent ACTIVE class (priority isolation)."""
        now = time.perf_counter()
        floor = None
        if getattr(self, "preempt_rounds", None) is not None and self.active:
            floor = min(self.effective_priority(r, now)
                        for r in self.active.values())
        best_i: Optional[int] = None
        best_key = None
        for i, r in enumerate(self.queue):
            quota = self._quota_of(r.tenant)
            if quota is not None and self._tenant_active.get(r.tenant, 0) >= quota:
                continue
            if floor is not None and self.effective_priority(r, now) > floor:
                continue
            key = self._admission_key(r, now)
            if best_key is None or key < best_key:
                best_i, best_key = i, key
        if best_i is None:
            return None
        if best_i == 0:
            return self.queue.popleft()
        req = self.queue[best_i]
        del self.queue[best_i]
        return req

    def _grant_slot(self, req: Request):
        """Bind the request to a free slot; returns its prompt buffer
        (freed again when the prefill retires), or None when resuming a
        preempted chain — the parked ``(cache, tok, pos)`` is restored
        verbatim. For fresh admissions the slot value resets to a zero
        cache, no token and position 0, so nothing of the previous
        occupant carries over. (The reference keeps the previous cache:
        harmless for attention, whose stale rows are masked, but an RG-LRU
        or Mamba prefill then starts from the old recurrent state and conv tail, so
        its tokens depend on the slot's history; ROADMAP queue 3.)"""
        req.slot = self.free.pop(0)
        if req.t_admit == 0.0:  # first grant only: resume keeps the original
            req.t_admit = time.perf_counter()
        self.active[req.slot] = req
        self._tenant_active[req.tenant] = \
            self._tenant_active.get(req.tenant, 0) + 1
        if req.parked_state is not None:
            self.slots[req.slot].value = req.parked_state
            req.parked_state = None
            return None
        self.slots[req.slot].value = (
            init_cache(self.cfg, 1, self.max_len, device=self.device), None, 0)
        return self.pool.alloc((1, len(req.prompt)), np.int32, name=f"req{req.rid}_prompt",
                               value=req.prompt[None])

    def _release_slot(self, s: int) -> Request:
        """Unbind slot ``s``: drop it from the active set, decrement the
        tenant's incremental count, return the slot to the free list."""
        req = self.active.pop(s)
        n = self._tenant_active.get(req.tenant, 0) - 1
        if n > 0:
            self._tenant_active[req.tenant] = n
        else:
            self._tenant_active.pop(req.tenant, None)
        self.free.append(s)
        return req

    def _harvest_slot(self, s: int) -> Optional[Request]:
        """Read the slot's freshly decoded token; return the request if it
        finished (slot freed), else None."""
        req = self.active[s]
        _, tok, pos = self.slots[s].value
        req.generated.append(self._read_int(tok))
        if req.done or self._read_int(pos) >= self.max_len - 1:
            req.t_finish = time.perf_counter()
            self._release_slot(s)
            return req
        return None


class ContinuousBatchingServer(_ServingCore):
    """Per-step batch-drain serving (the baseline the session server is
    measured against): every iteration rebuilds a ``TaskStream``, runs it to
    empty through a closed-batch scheduler, and blocks the host."""

    def __init__(self, cfg: ArchConfig, params: LanguageModel, *, max_slots: int = 4,
                 max_len: int = 64, window: int = 32, max_queue: int = 256,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quota: Optional[Union[int, Dict[str, int]]] = None,
                 aging_s: Optional[float] = 5.0, device: DeviceLike = "cuda"):
        super().__init__(cfg, params, max_slots=max_slots, max_len=max_len,
                         max_queue=max_queue, tenant_weights=tenant_weights,
                         tenant_quota=tenant_quota, aging_s=aging_s, device=device)
        # slot values are opaque tuples, which vmap cannot stack: waves run
        # through the serial executor — the window still builds multi-task
        # waves, which is the dependency-schedule evidence.
        self.scheduler = WaveScheduler(window_size=window,
                                       executor=SerialExecutor(self.device))

    def step(self) -> List[Request]:
        """One server iteration: admit + prefill new requests, decode the
        active set — all through the ACS window. Returns finished requests."""
        stream = TaskStream()

        prompt_bufs: List[str] = []
        while self.queue and self.free:
            req = self._pick_next()
            if req is None:
                break
            tok_buf = self._grant_slot(req)
            prompt_bufs.append(tok_buf.name)
            self._prefill_kernel.launch(
                stream, inputs=(self.slots[req.slot], tok_buf),
                outputs=(self.slots[req.slot],),
            )

        # decode wave over slots that hold a token AND can still take a
        # round (not done, not at cache capacity)
        decoding = [s for s, r in self.active.items()
                    if self.slots[s].value[1] is not None and not r.done
                    and self._read_int(self.slots[s].value[2]) < self.max_len - 1]
        if decoding:
            bufs = tuple(self.slots[s] for s in decoding)
            self._decode_kernel.launch(stream, inputs=bufs, outputs=bufs)

        if not stream.tasks:
            return []
        report = self.scheduler.run(stream.tasks)
        for name in prompt_bufs:
            self.pool.free(name)
        entry = report.as_dict()
        entry["tasks_this_run"] = sum(len(w) for w in report.waves)
        entry["waves_this_run"] = len(report.waves)
        self.report_log.append(entry)

        finished = []
        for s in list(decoding):
            req = self._harvest_slot(s)
            if req is not None:
                finished.append(req)
        # zero-round finish: active slots whose prefill retired but which
        # can never decode (max_new=0, or the prompt fills the cache)
        for s in list(self.active):
            req = self.active[s]
            _, tok, pos = self.slots[s].value
            if tok is not None and (
                    req.done or self._read_int(pos) >= self.max_len - 1):
                req.t_finish = time.perf_counter()
                self._release_slot(s)
                finished.append(req)
        return finished

    def run_until_drained(self, max_iters: int = 200) -> List[Request]:
        """Step until queue and slots are empty. Raises
        :class:`DrainTimeout` if ``max_iters`` steps don't drain the server."""
        out: List[Request] = []
        for _ in range(max_iters):
            out.extend(self.step())
            if not self.queue and not self.active:
                return out
        raise DrainTimeout(
            f"run_until_drained: {max_iters} steps left "
            f"{len(self.queue)} queued / {len(self.active)} active requests",
            queue_depth=len(self.queue), active_slots=len(self.active),
            finished=out)


class SessionServer(_ServingCore):
    """Open-loop serving on a persistent scheduler session.

    Admission emits a request's *entire* kernel program — prefill plus its
    count-bounded decode chain — into the live window while other
    requests' chains are still in flight; the window's RAW hazards
    serialize each chain on its own slot buffer and co-schedule
    independent chains. ``pump()`` is the non-blocking service iteration:
    poll the session (retirement callbacks harvest tokens, free prompt
    buffers, finish requests), then admit queued requests into freed
    slots.

    ``scheduler="frontier"`` (the default, as in the reference) runs the
    async :class:`~..core.frontier.FrontierSession` with ``max_group=1``,
    because slot values are opaque and cannot be stacked, and up to
    ``max_inflight`` tasks in flight: each retires when its CUDA event
    completes, with no host sync per task. ``scheduler="wave"`` runs the
    live :class:`~..core.session.WaveSession` with a serial executor: each
    poll launches the READY set as one wave (one slot's decode co-resident
    with another's prefill). ``scheduler="device"`` runs the persistent
    :class:`~..core.device_dispatch.DeviceSession` (``plan_mode``, default
    ``"loop"`` as in the reference); every serving task has opaque slot
    values, so each takes the session's in-epoch host path, and the pool's
    free hook releases freed buffers' arena rows. ``scheduler="mesh"``
    serves through :class:`~..core.mesh_session.MeshDeviceSession`
    (``n_shards``, default one a visible card; ``transfer_mode``,
    ``overlap_drains``): the admission plane places each request's chain
    on one shard (its slot buffer's RAW chain pins it there), each shard
    runs on its own CUDA stream, and the free hook reaches every shard's
    arena. Each pump samples how many active slots each shard owns
    (``shard_occupancy``) into the bounded ``shard_slot_samples`` trace,
    whose means, with the session's transfer counters, land in the close
    report.

    **Cooperative preemption** (``preempt_rounds``): with the default
    ``None``, a request's whole decode chain is emitted at admission. With
    ``preempt_rounds=k``, chains are emitted in segments of at most ``k``
    decode rounds; at each segment boundary the chain either continues,
    finishes, or *yields its slot* to a strictly more urgent admissible
    request: its opaque ``(cache, token, pos)`` state is parked on the
    Request, the slot is freed, and the request re-queues at its original
    age. Resume restores the parked state verbatim — no recompute, and the
    token stream is bit-identical to an unpreempted run.
    """

    SCHEDULERS = ("frontier", "wave", "device", "mesh")

    def __init__(self, cfg: ArchConfig, params: LanguageModel, *, max_slots: int = 4,
                 max_len: int = 64, window: int = 32, max_queue: int = 256,
                 scheduler: str = "frontier", max_inflight: int = 8,
                 history_limit: Optional[int] = 1024,
                 plan_mode: str = "loop", n_shards: Optional[int] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 tenant_quota: Optional[Union[int, Dict[str, int]]] = None,
                 aging_s: Optional[float] = 5.0,
                 preempt_rounds: Optional[int] = None,
                 transfer_mode: str = "auto",
                 overlap_drains: bool = True,
                 device: DeviceLike = "cuda"):
        if scheduler not in self.SCHEDULERS:
            raise ValueError(
                f"session server scheduler must be one of {self.SCHEDULERS}, "
                f"got {scheduler!r}")
        super().__init__(cfg, params, max_slots=max_slots, max_len=max_len,
                         max_queue=max_queue, history_limit=history_limit,
                         tenant_weights=tenant_weights,
                         tenant_quota=tenant_quota, aging_s=aging_s, device=device)
        if preempt_rounds is not None and preempt_rounds < 1:
            raise ValueError(
                f"preempt_rounds must be >= 1 or None, got {preempt_rounds}")
        self.preempt_rounds = preempt_rounds
        if scheduler == "device":
            self.session = DeviceSession(window_size=window, plan_mode=plan_mode,
                                         history_limit=history_limit, device=self.device)
            # Freeing a pool buffer (a prompt) releases its arena row, so
            # the session's slabs stay bounded under unbounded traffic.
            self.pool.add_free_hook(self.session.release_buffer)
        elif scheduler == "mesh":
            self.session = MeshDeviceSession(window_size=window, n_shards=n_shards,
                                             history_limit=history_limit,
                                             transfer_mode=transfer_mode,
                                             overlap_drains=overlap_drains, device=self.device)
            # As for "device", reaching every shard's arena (a freed buffer
            # may hold rows on several).
            self.pool.add_free_hook(self.session.release_buffer)
        elif scheduler == "frontier":
            self.session = FrontierSession(window_size=window, max_inflight=max_inflight,
                                           max_group=1, history_limit=history_limit,
                                           device=self.device)
        else:
            self.session = WaveSession(window_size=window,
                                       executor=SerialExecutor(self.device),
                                       history_limit=history_limit)
        self.scheduler_name = scheduler
        self._finished: List[Request] = []
        # set during close(): the flush retires chains (firing _finish_slot),
        # but a closing window must not receive fresh admissions
        self._closing = False
        # tid -> prefill | decode for tasks currently IN FLIGHT; entries
        # drop at retirement.
        self.task_kinds: Dict[int, str] = {}
        self.occupancy_samples: Deque[int] = collections.deque(
            maxlen=history_limit)
        # mesh only: one {shard: active slots} sample per pump and per
        # request retirement, bounded like every monitoring trace.
        self.shard_slot_samples: Deque[Dict[int, int]] = collections.deque(
            maxlen=history_limit)

    # -- retirement callbacks (fire inside session.poll/drive) --------------
    def _finish_slot(self, slot: int) -> None:
        if self.scheduler_name == "mesh":
            # Sampled while the finishing slot is still active: its chain
            # just ran, so its shard is known.
            self.shard_slot_samples.append(self.shard_occupancy())
        req = self._release_slot(slot)
        req.t_finish = time.perf_counter()
        self._finished.append(req)
        self._admit_ready()

    def _on_prefill_retired(self, task, buf_name: str, slot: int,
                            finish: bool) -> None:
        self.pool.free(buf_name)  # no leak
        self.task_kinds.pop(task.tid, None)
        if finish:  # zero decode rounds: the prefill IS the whole program
            self._finish_slot(slot)

    def _on_decode_retired(self, task, slot: int, boundary: bool) -> None:
        self.task_kinds.pop(task.tid, None)
        req = self.active[slot]
        _, tok, _ = self.slots[slot].value
        req.generated.append(self._read_int(tok))
        req.rounds_left -= 1
        if not boundary:
            return
        # Segment boundary: finish, yield the slot, or emit the next
        # segment (the continuation submits from inside the retirement
        # callback — the session RLock permits it).
        if req.rounds_left <= 0:
            self._finish_slot(slot)
        elif self._should_yield(req):
            self._park(slot)
        else:
            self._emit_decode_segment(req)

    def _should_yield(self, req: Request) -> bool:
        """Cooperative-preemption test at a segment boundary: yield iff
        strictly more urgent work exists — RUNNING in another slot, or
        admissible in the queue with no free slot to serve it. Equal
        urgency never preempts, and quota-blocked waiters don't trigger a
        park they couldn't use."""
        if self.preempt_rounds is None:
            return False
        now = time.perf_counter()
        mine = self.effective_priority(req, now)
        for r in self.active.values():
            if r is not req and self.effective_priority(r, now) < mine:
                return True
        if self.free or not self.queue:
            return False
        for r in self.queue:
            quota = self._quota_of(r.tenant)
            if quota is not None and self._tenant_active.get(r.tenant, 0) >= quota:
                continue
            if self.effective_priority(r, now) < mine:
                return True
        return False

    def _park(self, slot: int) -> None:
        """Preempt: capture the chain's opaque slot state, free the slot,
        and re-queue the request at its original age."""
        req = self._release_slot(slot)
        req.parked_state = self.slots[slot].value
        req.slot = None
        req.preemptions += 1
        self.preemptions += 1
        self.queue.append(req)
        self._admit_ready()

    # -- service loop --------------------------------------------------------
    def _admit_ready(self) -> None:
        """Admission sweep: grant free slots to queued requests in QoS
        order. Runs between pumps AND from the slot-freeing retirement
        callbacks (finish, park), so a successor's program joins the same
        cascade."""
        if self._closing or self.session.closed:
            return
        while self.queue and self.free:
            req = self._pick_next()
            if req is None:  # everything queued is quota-blocked/held back
                break
            self._admit(req)

    def _admit(self, req: Request) -> None:
        """Emit the request's kernel program into the live window: the
        prefill plus its decode chain — whole (``preempt_rounds=None``:
        termination is count-based, so the full chain is known up front)
        or in preemptible segments. A resumed request skips the prefill."""
        tok_buf = self._grant_slot(req)
        s = req.slot
        if tok_buf is None:  # resuming a preempted chain
            self._emit_decode_segment(req)
            return
        stream = self._stream_for(req)
        task = self._prefill_kernel.launch(
            stream, inputs=(self.slots[s], tok_buf), outputs=(self.slots[s],))
        self.task_kinds[task.tid] = "prefill"
        # Decode rounds the cache can actually hold: zero when max_new=0 or
        # the prompt already fills it.
        req.rounds_left = min(req.max_new, self.max_len - 1 - len(req.prompt))
        self.session.on_task_retired(
            task, lambda t, n=tok_buf.name, s=s, fin=(req.rounds_left == 0):
            self._on_prefill_retired(t, n, s, fin))
        self._emit_decode_segment(req, stream)

    def _stream_for(self, req: Request) -> TaskStream:
        """Live per-request stream: AcsKernel.launch feeds the session's
        window directly, tagged for per-request accounting and stamped
        with the request's current effective priority bucket."""
        return TaskStream(sink=self.session, tag=f"req{req.rid}",
                          record=False,
                          priority=self.effective_priority(req))

    def _emit_decode_segment(self, req: Request,
                             stream: Optional[TaskStream] = None) -> None:
        """Emit the next run of decode rounds for the request's chain:
        everything left when ``preempt_rounds`` is None, else at most
        ``preempt_rounds`` rounds."""
        if req.rounds_left <= 0:
            return
        s = req.slot
        if stream is None:
            stream = self._stream_for(req)
        seg = (req.rounds_left if self.preempt_rounds is None
               else min(req.rounds_left, self.preempt_rounds))
        bufs = (self.slots[s],)
        for k in range(seg):
            dtask = self._decode_kernel.launch(stream, inputs=bufs, outputs=bufs)
            self.task_kinds[dtask.tid] = "decode"
            self.session.on_task_retired(
                dtask,
                lambda t, s=s, boundary=(k == seg - 1):
                self._on_decode_retired(t, s, boundary))

    def pump(self) -> List[Request]:
        """One non-blocking service iteration; returns newly finished
        requests. Safe after ``close()``: it then only drains requests that
        finished during the closing flush."""
        if not self.session.closed:
            self.session.poll()
            self._admit_ready()
            self.occupancy_samples.append(self.session.window.resident())
            if self.scheduler_name == "mesh":
                self.shard_slot_samples.append(self.shard_occupancy())
        out, self._finished = self._finished, []
        return out

    def shard_occupancy(self) -> Dict[int, int]:
        """Per-shard slot accounting (mesh scheduler): how many ACTIVE
        request slots each shard owns, a slot being the shard's that last
        wrote its buffer (where its chain runs). Slots whose chain has not
        run yet are not attributed."""
        counts: Dict[int, int] = {}
        shard_of = getattr(self.session, "shard_of", None)
        if shard_of is None:
            return counts
        for s in self.active:
            shard = shard_of(self.slots[s])
            if shard is not None:
                counts[shard] = counts.get(shard, 0) + 1
        return counts

    def run_until_drained(self, max_iters: int = 10_000) -> List[Request]:
        """Serve until queue and slots empty. Raises :class:`DrainTimeout`
        when ``max_iters`` pumps don't drain the server."""
        out: List[Request] = []
        for _ in range(max_iters):
            done = self.pump()
            out.extend(done)
            if not self.queue and not self.active:
                return out
            if not done:
                self.session.drive()
        raise DrainTimeout(
            f"run_until_drained: {max_iters} pumps left "
            f"{len(self.queue)} queued / {len(self.active)} active requests",
            queue_depth=len(self.queue), active_slots=len(self.active),
            finished=out)

    def close(self):
        """Close the underlying session and log its final report. Chains
        still in flight retire during the closing flush — collect those
        requests with one more ``pump()`` after close. Under
        ``preempt_rounds`` continuation segments are emitted lazily from
        retirement callbacks, which cannot feed a closing window — so drain
        first."""
        if self.preempt_rounds is not None and (self.queue or self.active):
            # two statements on purpose: pump() REBINDS self._finished, so
            # the attribute must be read after run_until_drained returns
            drained = self.run_until_drained()
            self._finished.extend(drained)
        self._closing = True
        report = self.session.close()
        entry = report.as_dict()
        entry["preemptions"] = self.preemptions
        entry["host_reads"] = self.host_reads
        entry["occupancy_mean"] = (
            float(np.mean(self.occupancy_samples)) if self.occupancy_samples else 0.0)
        if hasattr(report, "session_stats"):  # device and mesh session counters
            entry["device_session"] = dict(report.session_stats)
        if self.shard_slot_samples:  # mesh per-shard slot accounting
            shards: Dict[int, List[int]] = {}
            for sample in self.shard_slot_samples:
                for shard, n in sample.items():
                    shards.setdefault(shard, []).append(n)
            entry["shard_slots_mean"] = {
                str(shard): float(np.mean(v)) for shard, v in sorted(shards.items())}
        if self.scheduler_name == "mesh":
            stats = report.session_stats
            for key in ("transfer_mode", "d2d_moves", "staged_moves", "d2d_fallbacks",
                        "drain_overlap", "overlap_drains"):
                entry[key] = stats[key]
        self.report_log.append(entry)
        return report
