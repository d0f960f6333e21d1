"""Continuous-batching serving scheduler with load shedding and a watchdog.

Counterpart of ``repro.launch.scheduler``: requests *fan in* from a queue
onto a fixed set of decode slots sharing one batched KV cache, decode
advances every occupied slot one token per tick, and finished requests
*fan out* to the done list, freeing their slot for the next admission —
prefill and decode stay decoupled, the batch never drains to refill.

Accuracy is the load-shed axis: the scheduler holds a ladder of
:class:`ServeLevel` rungs, each an
:class:`~repro_torch.core.approx.ApproxConfig`. When the queue deepens to
``shed_depth`` it steps to the next coarser rung, and when it drains to
``recover_depth`` it steps back up. The KV cache is plain float state,
level-independent, so a swap only sends the next tick through another
rung's step.

On the GPU every rung's prefill (:func:`~repro_torch.launch.serve.
make_prefill`, at the fixed ``(batch, prompt_len)`` admission shape) and
decode step (:func:`~repro_torch.launch.serve.make_decode_step`) are
captured as CUDA graphs once, at :meth:`Scheduler.warmup`, and replayed
after that: the reference compiles its executables there, so that
serving never compiles mid-drill. All rungs' steps serve one cache
(:meth:`~repro_torch.launch.serve.DecodeStep.adopt_cache`): there is no
copy between rungs. An admission's prefill cache goes into it through
:func:`~repro_torch.launch.serve.insert_cache`, eagerly between replays.
``eager=True`` runs ``lm.prefill`` and ``lm.decode_step`` instead (the
counterpart of ``generate(..., decode_fn=lm.decode_step)``), for holding
the captured drill to the eager one. On the CPU both are eager.

Self-healing (``self_heal=True``, the default): the ladder grows one
**recovery rung**, the base config forced exact, touching no correction
tables, and a per-tick watchdog feeds it. It detects poisoned work by
per-row non-finite logits at prefill and decode (``watch_logits``), by a
correction-table integrity scrub every ``scrub_every`` ticks
(:mod:`repro_torch.faults.scrub`: it reads back every materialized copy
of the tables, those the kernels and the captured graphs read included —
the only deterministic detector for persistent table upsets, which
corrupt results while staying finite, and the only one that sees into a
replayed graph), by a tick budget (``tick_budget``), and by
:class:`~repro_torch.kernels.registry.GuardTripped` escaping a guarded
eager dispatch (a capture's warm run included; replays are never
checked). Detected work is **quarantined**: the slot is freed, the
request's partial tokens are discarded, and it re-enters the queue
pinned to the recovery rung after an exponential backoff, up to
``max_retries`` — then it fails loudly (``stats()['failed']``). While
the scrub reads dirty, every tick dispatches at the recovery rung.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.approx import ApproxConfig
from repro_torch.kernels.registry import GuardTripped
from repro_torch.models import build

__all__ = [
    "Request",
    "ServeLevel",
    "Scheduler",
    "coarse_step",
    "default_ladder",
]


@dataclass
class Request:
    """One serving request: a fixed-length prompt and a token budget."""
    rid: int
    prompt: np.ndarray           # (prompt_len,) int64
    max_new: int
    tokens: list = field(default_factory=list)
    levels: list = field(default_factory=list)   # serving level per token
    submitted: int = -1          # ticks (scheduler time, not wall-clock)
    started: int = -1
    finished: int = -1
    # --- watchdog / retry state ---
    retries: int = 0             # quarantine-and-retry count so far
    not_before: int = 0          # earliest re-admission tick (backoff)
    pinned_exact: bool = False   # retried: serve on the recovery rung only
    failed: bool = False         # gave up after max_retries (loud, never
    fail_reason: str = ""        # silently served) — see Scheduler._bounce


@dataclass(frozen=True)
class ServeLevel:
    """One accuracy rung of the serving ladder (finest first)."""
    name: str
    approx: ApproxConfig


def coarse_step(approx: ApproxConfig) -> ApproxConfig:
    """One rung coarser than ``approx``: uncorrected Mitchell on the same
    lanes, policy dropped. An exact base steps into divider-softmax
    Mitchell."""
    if not approx.enabled:
        return replace(approx, mode="mitchell", emulate=False,
                       use_in_softmax=True, policy=None, layer=None)
    return replace(approx, mode="mitchell", policy=None, layer=None)


def default_ladder(approx: ApproxConfig) -> tuple[ServeLevel, ...]:
    """The two-rung default: the deployment's own config, and one
    Mitchell-coarse shed rung."""
    return (ServeLevel("fine", approx),
            ServeLevel("shed", coarse_step(approx)))


class Scheduler:
    """Continuous-batching scheduler over shared step functions.

    One tick = (watchdog) -> (adjust level by queue depth) -> (admit queued
    requests into free slots via one fixed-shape batched prefill) -> (one
    decode step advancing every occupied slot). Prefill always runs at the
    full ``(batch, prompt_len)`` shape (unused rows are padding whose cache
    rows are dropped), and decode always at ``(batch,)`` with per-row
    positions — each rung's graphs are captured once, at :meth:`warmup`.

    Inactive slots decode garbage rows (position held at 0, so no history
    is read) that cost their share of the batch but never touch live
    state; their cache rows are overwritten by the next admission's
    insert.
    """

    def __init__(self, cfg, params=None, *,
                 levels: tuple[ServeLevel, ...] | None = None,
                 batch: int = 4, prompt_len: int = 32,
                 max_seq: int | None = None,
                 shed_depth: int = 4, recover_depth: int = 1,
                 seed: int = 0,
                 self_heal: bool = True, max_retries: int = 2,
                 retry_backoff: int = 2, tick_budget: int | None = None,
                 scrub_every: int = 0, watch_logits: bool = True,
                 device: torch.device | str = "cuda", eager: bool = False):
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                f"Scheduler needs an attention-family cache, got family "
                f"{cfg.family!r} (recurrent state has no per-slot seq axis)")
        if prompt_len <= 0:
            raise ValueError(
                f"prompt_len must be positive, got {prompt_len} — a "
                "zero-length prompt has no tokens to prefill (admit a "
                "BOS-padded prompt upstream instead)")
        if levels is None:
            levels = default_ladder(cfg.approx)
        levels = tuple(levels)
        if recover_depth >= shed_depth:
            raise ValueError(
                f"recover_depth ({recover_depth}) must be < shed_depth "
                f"({shed_depth}) — equal thresholds oscillate every tick")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.cfg = cfg
        self.self_heal = bool(self_heal)
        self.max_retries = int(max_retries)
        self.retry_backoff = max(int(retry_backoff), 1)
        self.tick_budget = tick_budget
        self.scrub_every = int(scrub_every)
        self.watch_logits = bool(watch_logits)
        # the load-shed ladder spans [0, _ladder_n); the recovery rung
        # (base config forced exact) sits past it, reachable only through
        # the watchdog, never by shedding
        self._ladder_n = len(levels)
        if self.self_heal and all(lv.name != "recovery" for lv in levels):
            levels = levels + (ServeLevel("recovery", replace(
                levels[0].approx, mode="exact", policy=None, layer=None)),)
        self.levels = levels
        self.batch = batch
        self.prompt_len = prompt_len
        self.max_seq = max_seq or prompt_len * 2
        self.shed_depth = shed_depth
        self.recover_depth = recover_depth
        self.eager = bool(eager)
        self.lms = tuple(build(cfg.with_approx(lv.approx), device=device)
                         for lv in self.levels)
        self.device = self.lms[0].device
        self.params = params if params is not None \
            else self.lms[0].init(seed)
        # one level-independent cache; on the GPU every rung's captured
        # step serves its buffers (adopt_cache), so a level swap is a
        # different replay on the same state
        self.cache = self.lms[0].empty_cache(batch, self.max_seq)
        if self.eager:
            self.prefills = tuple(lm.prefill for lm in self.lms)
            self.steps = tuple(lm.decode_step for lm in self.lms)
        else:
            from repro_torch.launch.serve import (make_decode_step,
                                                  make_prefill)
            self.prefills = tuple(make_prefill(lm) for lm in self.lms)
            self.steps = tuple(make_decode_step(lm) for lm in self.lms)
            for step in self.steps:
                step.adopt_cache(self.cache)
        self.pos = np.zeros(batch, np.int64)
        self.tok = np.zeros(batch, np.int64)
        self.slots: list[Request | None] = [None] * batch
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        self.failed: list[Request] = []
        self.retryq: list[Request] = []      # quarantined, backing off
        self.level = 0
        self.tick_no = 0
        self.events: list[tuple[int, str, object]] = []
        self._next_rid = 0
        self.counters = {"guard_trips": 0, "quarantines": 0,
                         "retries": 0, "timeouts": 0}
        self._poisoned = False               # last scrub found corruption
        if self.scrub_every > 0:
            from repro_torch.faults.scrub import config_table_identities
            idents: list = []
            for lv in self.levels:
                for t in config_table_identities(
                        lv.approx, n_layers=getattr(cfg, "n_layers", 0)):
                    if t not in idents:
                        idents.append(t)
            self._scrub_idents = tuple(idents)
        else:
            self._scrub_idents = ()

    # ------------------------------------------------------------ intake --
    def submit(self, prompt, max_new: int) -> Request:
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.shape[0] != self.prompt_len:
            raise ValueError(
                f"prompt length {prompt.shape[0]} != scheduler prompt_len "
                f"{self.prompt_len} (fixed-shape prefill: pad upstream)")
        if self.prompt_len + max_new > self.max_seq:
            raise ValueError(
                f"prompt_len + max_new = {self.prompt_len + max_new} "
                f"exceeds max_seq {self.max_seq}")
        req = Request(rid=self._next_rid, prompt=prompt, max_new=max_new,
                      submitted=self.tick_no)
        self._next_rid += 1
        self.queue.append(req)
        return req

    # ----------------------------------------------------------- warmup --
    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    def warmup(self) -> int:
        """Run every level's prefill and decode step once up front: on the
        GPU this captures each rung's two graphs (a warm eager run, then
        the capture), so serving never captures mid-drill — a level swap
        is a replay, not a capture. Returns the number of executables
        warmed (2 per level), as the reference does."""
        dummy_p = np.zeros((self.batch, self.prompt_len), np.int64)
        dummy_t = np.zeros(self.batch, np.int64)
        n = 0
        for prefill, step in zip(self.prefills, self.steps):
            prefill(self.params, {"tokens": self._on_device(dummy_p)})
            step(self.params, self.cache, self._on_device(dummy_t),
                 self._on_device(dummy_t))
            n += 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    # ------------------------------------------------------------- steps --
    def _adjust_level(self):
        # sheds move within the ladder only — the recovery rung past
        # _ladder_n belongs to the watchdog, never to queue pressure
        depth = len(self.queue)
        if depth >= self.shed_depth and self.level < self._ladder_n - 1:
            self.level += 1
            self.events.append(
                (self.tick_no, "shed", self.levels[self.level].name))
        elif depth <= self.recover_depth and self.level > 0:
            self.level -= 1
            self.events.append(
                (self.tick_no, "recover", self.levels[self.level].name))

    # ---------------------------------------------------------- watchdog --
    def _effective_level(self, admitting=()) -> int:
        """The level this tick actually dispatches at: the recovery rung
        while the tables scrub dirty or any live or admitting request is
        pinned there (exact is the finest rung, so forcing the shared
        batch up never serves anyone coarser than their ladder level);
        otherwise the shed ladder's current level."""
        if self.self_heal and (self._poisoned or any(
                r is not None and r.pinned_exact
                for r in list(self.slots) + list(admitting))):
            return len(self.levels) - 1
        return self.level

    def _rows_ok(self, logits) -> np.ndarray:
        """Per-row logit health (batch,): finite everywhere. Non-finite
        rows mean the slot's state is poisoned — quarantine, don't argmax
        garbage into someone's completion."""
        if not (self.self_heal and self.watch_logits):
            return np.ones(self.batch, bool)
        return torch.isfinite(logits).all(dim=-1).cpu().numpy()

    def _bounce(self, req: Request, reason: str):
        """Discard a poisoned request's partial work and either requeue
        it pinned to the recovery rung (exponential backoff) or fail it
        loudly after ``max_retries`` — never silently serve it."""
        req.tokens.clear()
        req.levels.clear()
        req.started = -1
        if req.retries >= self.max_retries:
            req.failed = True
            req.fail_reason = reason
            req.finished = self.tick_no
            self.failed.append(req)
            self.events.append((self.tick_no, "fail", req.rid))
            return
        req.retries += 1
        self.counters["retries"] += 1
        req.not_before = self.tick_no + self.retry_backoff ** req.retries
        req.pinned_exact = True
        self.retryq.append(req)
        self.events.append((self.tick_no, "retry", req.rid))

    def _quarantine(self, s: int, req: Request, reason: str):
        """Free a poisoned slot and bounce its request."""
        self.counters["quarantines"] += 1
        self.slots[s] = None
        self.pos[s] = 0
        self.tok[s] = 0
        self.events.append((self.tick_no, "quarantine", req.rid))
        self._bounce(req, reason)

    def _watchdog(self):
        """Per-tick health pass: table scrub, tick budgets, due retries.

        Runs before admit / decode, so corruption found here quarantines
        in-flight work *before* another token is computed through it.
        """
        if self.scrub_every > 0 and self.tick_no % self.scrub_every == 0:
            from repro_torch.faults.scrub import scrub_tables

            findings = scrub_tables(self._scrub_idents)
            if findings and not self._poisoned:
                self._poisoned = True
                self.events.append((self.tick_no, "scrub-dirty",
                                    "; ".join(str(f) for f in findings)))
                # every unpinned in-flight token went through the
                # corrupted tables — discard and retry on the exact rung
                for s, req in enumerate(self.slots):
                    if req is not None and not req.pinned_exact:
                        self._quarantine(s, req,
                                         f"table scrub: {findings[0]}")
            elif not findings and self._poisoned:
                # upset cleared / table repaired: lift the pin
                self._poisoned = False
                self.events.append((self.tick_no, "scrub-clean", ""))
        if self.tick_budget is not None:
            for s, req in enumerate(self.slots):
                if req is not None and req.started >= 0 and \
                        self.tick_no - req.started > self.tick_budget:
                    self.counters["timeouts"] += 1
                    self.events.append((self.tick_no, "timeout", req.rid))
                    self._quarantine(
                        s, req,
                        f"tick budget {self.tick_budget} exceeded")
        if self.retryq:
            due = [r for r in self.retryq if r.not_before <= self.tick_no]
            if due:
                self.retryq = [r for r in self.retryq
                               if r.not_before > self.tick_no]
                for r in reversed(due):    # retries go to the queue front
                    self.queue.appendleft(r)

    def _admit(self):
        from repro_torch.launch.serve import insert_cache

        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free or not self.queue:
            return
        take = min(len(free), len(self.queue))
        reqs = [self.queue.popleft() for _ in range(take)]
        prompts = np.zeros((self.batch, self.prompt_len), np.int64)
        # padding rows scatter out of range -> dropped by the insert
        slot_ix = np.full(self.batch, self.batch, np.int64)
        for j, req in enumerate(reqs):
            prompts[j] = req.prompt
            slot_ix[j] = free[j]
        lvl = self._effective_level(reqs)
        try:
            logits, pre = self.prefills[lvl](
                self.params, {"tokens": self._on_device(prompts)})
            first = logits.argmax(dim=-1).cpu().numpy()
            rowok = self._rows_ok(logits)
        except GuardTripped as e:
            # guarded dispatch rejected the whole prefill batch
            self.counters["guard_trips"] += 1
            self.events.append((self.tick_no, "guard", str(e)))
            for req in reqs:
                self._bounce(req, f"guard: {e.reason}")
            return
        insert_cache(self.cache, pre, slot_ix)
        name = self.levels[lvl].name
        for j, req in enumerate(reqs):
            if not rowok[j]:
                self.counters["quarantines"] += 1
                self.events.append((self.tick_no, "quarantine", req.rid))
                self._bounce(req, "non-finite prefill logits")
                continue
            s = free[j]
            self.slots[s] = req
            self.pos[s] = self.prompt_len
            self.tok[s] = first[j]
            req.tokens.append(int(first[j]))
            req.levels.append(name)
            req.started = self.tick_no
            self.events.append((self.tick_no, "admit", req.rid))

    def _retire(self, s: int, req: Request):
        req.finished = self.tick_no
        self.done.append(req)
        self.slots[s] = None
        self.pos[s] = 0
        self.tok[s] = 0
        self.events.append((self.tick_no, "retire", req.rid))

    def _decode(self):
        if not any(r is not None for r in self.slots):
            return
        lvl = self._effective_level()
        try:
            logits, cache = self.steps[lvl](
                self.params, self.cache, self._on_device(self.tok),
                self._on_device(self.pos))
        except GuardTripped as e:
            self.counters["guard_trips"] += 1
            self.events.append((self.tick_no, "guard", str(e)))
            for s, req in enumerate(self.slots):
                if req is not None:
                    self._quarantine(s, req, f"guard: {e.reason}")
            return
        self.cache = cache
        nxt = logits.argmax(dim=-1).cpu().numpy()
        rowok = self._rows_ok(logits)
        name = self.levels[lvl].name
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            if not rowok[s]:
                self._quarantine(s, req, "non-finite decode logits")
                continue
            self.pos[s] += 1
            if len(req.tokens) >= req.max_new:
                self._retire(s, req)
                continue
            t = int(nxt[s])
            req.tokens.append(t)
            req.levels.append(name)
            self.tok[s] = t
            if len(req.tokens) >= req.max_new:
                self._retire(s, req)

    def step(self):
        """One scheduler tick: watchdog, adjust level, admit, decode."""
        self.tick_no += 1
        if self.self_heal:
            self._watchdog()
        self._adjust_level()
        self._admit()
        self._decode()

    def run(self, max_ticks: int = 10_000) -> dict:
        """Tick until every submitted request retires (or fails loudly
        after its retry budget); returns stats."""
        while (self.queue or self.retryq
               or any(r is not None for r in self.slots)):
            if self.tick_no >= max_ticks:
                raise RuntimeError(
                    f"scheduler did not drain in {max_ticks} ticks "
                    f"(queue={len(self.queue)}, "
                    f"retrying={len(self.retryq)}, active="
                    f"{sum(r is not None for r in self.slots)})")
            self.step()
        return self.stats()

    # ------------------------------------------------------------- stats --
    def stats(self) -> dict:
        per_level: dict[str, int] = {lv.name: 0 for lv in self.levels}
        for req in self.done + [r for r in self.slots if r is not None]:
            for name in req.levels:
                per_level[name] += 1
        return {
            "completed": len(self.done),
            "failed": len(self.failed),
            "ticks": self.tick_no,
            "tokens": sum(per_level.values()),
            "tokens_per_level": per_level,
            "sheds": sum(1 for _, kind, _ in self.events if kind == "shed"),
            "recovers": sum(1 for _, kind, _ in self.events
                            if kind == "recover"),
            "guard_trips": self.counters["guard_trips"],
            "quarantines": self.counters["quarantines"],
            "retries": self.counters["retries"],
            "timeouts": self.counters["timeouts"],
            "poisoned": self._poisoned,
            "events": list(self.events),
        }

    def measure_decode(self, iters: int = 5):
        """Steady-state decode-step latency at the current level, device-
        synchronised after a warm call
        (:func:`repro_torch.metrics.timing.time_callable`; on the GPU one
        replay of the rung's captured step, host work included);
        ``items=batch`` makes ``items_per_s`` the decode tok/s."""
        from repro_torch.metrics.timing import time_callable

        return time_callable(self.steps[self.level], self.params,
                             self.cache, self._on_device(self.tok),
                             self._on_device(self.pos), iters=iters,
                             items=self.batch, device=self.device)
