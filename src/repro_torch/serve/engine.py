"""Continuous-batching serve engine on dense KV slots.

Port of the dense-slot core of the reference package's ``serve/engine.py``:
``ServeConfig``, ``Request``, ``ServeResult``, ``FinishReason``, the
``Scheduler`` and ``ServeEngine.generate`` / ``ServeEngine.serve``.

The engine owns ``B = ServeConfig.max_batch`` persistent decode SLOTS over
one preallocated cache (``T.init_cache(cfg, B, max_seq)``).  One
``decode_step`` serves all slots at their own positions through per-slot
``pos``/``start`` vectors.  A request is admitted into a free slot by
prefilling its prompt, left-padded to a power-of-two bucket, into a fresh
batch=1 cache and copying that into the slot; the other slots keep
decoding.  A slot frees at its request's ``eos_id`` or token budget.

Batch invariance: a request's greedy tokens are the same bits solo or
admitted mid-flight next to other requests.  Pad keys are masked, RoPE
phases are relative to ``start``, the flash kernel anchors its kv tiles at
``start`` and reduces each row in a fixed order with no atomics, and every
other op is row-wise; both runs give every op the same shapes (decode over
``max_batch`` slots, prefill at batch 1).  A static batch (``generate``)
changes the bf16 products' shapes: on the CPU its tokens are the same bits
too (tests/test_torch_serve.py), on the card cuBLAS may pick another
reduction order for another shape.  Sampled requests draw from a generator
of their own (seeded from ``ServeConfig.seed`` and the request's key id),
once per token, so their stream does not depend on the slot or step.

Not ported yet (``ROADMAP.md``): streaming (``submit``/``serve_stream``),
deadlines, backpressure, snapshot/restore, the paged cache, packed prefill,
tensor-parallel meshes.  ``FinishReason`` carries EOS, MAX_NEW, SHED, FAULT.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def _broadcast(value, n: int, dtype, what: str) -> np.ndarray:
    """Scalar-or-per-request ServeConfig field -> validated (n,) array."""
    arr = np.asarray(value, dtype)
    if arr.ndim == 0:
        return np.full(n, arr, dtype)
    if arr.shape != (n,):
        raise ValueError(f"per-request {what} has shape {arr.shape}; "
                         f"expected a scalar or ({n},)")
    return arr


def _bucket(n: int, max_seq: int) -> int:
    """Prompt-length bucket: the smallest power of two >= max(n, 8), or the
    exact length when the bucket would leave no room for a new token."""
    if n + 1 > max_seq:
        raise ValueError(f"prompt length {n} cannot fit max_seq={max_seq} "
                         "with at least one new token")
    p = 8
    while p < n:
        p *= 2
    return p if p + 1 <= max_seq else n


class FinishReason(str, enum.Enum):
    """Terminal status of a served request."""

    EOS = "eos"            # sampled its eos_id
    MAX_NEW = "max_new"    # token budget exhausted
    SHED = "shed"          # refused at admission (invalid)
    FAULT = "fault"        # non-finite logits quarantined


@dataclasses.dataclass
class ServeResult:
    rid: int
    tokens: np.ndarray
    finish: FinishReason
    detail: str = ""


@dataclasses.dataclass
class ServeConfig:
    """Engine limits + default sampling parameters (scalar or per request)."""

    max_batch: int = 8
    max_seq: int = 512
    temperature: Union[float, Sequence[float]] = 0.0  # 0 = greedy
    eos_id: Union[int, Sequence[int]] = -1            # -1 = never stop early
    seed: int = 0
    strict: bool = False                 # raise on invalid requests
    health_checks: bool = True           # non-finite logits quarantine

    @classmethod
    def from_model(cls, cfg: ModelConfig, **overrides) -> "ServeConfig":
        kw = dict(max_batch=cfg.serve_max_batch, max_seq=cfg.serve_max_seq)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass
class Request:
    """One generation request; ``None`` fields take the ServeConfig value,
    ``seed`` pins the sampling-key id (default: the request's index)."""

    tokens: np.ndarray
    max_new: int = 32
    temperature: Optional[float] = None
    eos_id: Optional[int] = None
    seed: Optional[int] = None


class Scheduler:
    """Slot bookkeeping: admission/eviction and per-slot outputs.
    Per-step bookkeeping is vectorized over slots."""

    def __init__(self, n_slots: int, max_out: int):
        self.active = np.zeros(n_slots, bool)
        self.slot_req = np.full(n_slots, -1, np.int64)
        self.out_buf = np.zeros((n_slots, max(max_out, 1)), np.int32)
        self.out_len = np.zeros(n_slots, np.int64)
        self.budget = np.zeros(n_slots, np.int64)

    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(~self.active)

    def grow_out(self, max_out: int) -> None:
        cur = self.out_buf.shape[1]
        if max_out > cur:
            self.out_buf = np.pad(self.out_buf, ((0, 0), (0, max_out - cur)))

    def admit(self, slot: int, rid: int, max_new: int) -> None:
        self.grow_out(max_new)
        self.active[slot] = True
        self.slot_req[slot] = rid
        self.out_len[slot] = 0
        self.budget[slot] = max_new

    def record(self, tokens: np.ndarray, eos: np.ndarray):
        """Append this step's tokens for active slots; return the slots that
        just finished (EOS or budget)."""
        act = self.active.copy()
        self.out_buf[act, self.out_len[act]] = tokens[act]
        self.out_len[act] += 1
        finished = act & ((tokens == eos) | (self.out_len >= self.budget))
        return np.flatnonzero(finished)

    def record_one(self, slot: int, token: int, eos_id: int) -> bool:
        """Append an admission-time token; True if that finishes the request."""
        self.out_buf[slot, self.out_len[slot]] = token
        self.out_len[slot] += 1
        return token == eos_id or self.out_len[slot] >= self.budget[slot]

    def evict(self, slot: int) -> np.ndarray:
        out = self.out_buf[slot, : self.out_len[slot]].copy()
        self.active[slot] = False
        self.slot_req[slot] = -1
        return out

    @property
    def any_active(self) -> bool:
        return bool(self.active.any())


class ServeEngine:
    """Greedy / temperature serving of a dense model on ``device``."""

    def __init__(self, cfg: ModelConfig, params, sc: Optional[ServeConfig] = None,
                 device="cuda"):
        self.cfg = cfg
        self.params = params
        self.sc = sc if sc is not None else ServeConfig.from_model(cfg)
        self.device = T.resolve_device(device)
        self.last_results: Optional[List[ServeResult]] = None
        self.last_serve_stats: Optional[dict] = None

    # ------------------------------------------------------------- sampling

    def _generator(self, key_id: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((int(self.sc.seed) * 1_000_003 + int(key_id)) % (2 ** 63))
        return g

    def _sample(self, lg, temps: np.ndarray, gens) -> np.ndarray:
        """Tokens for every row of ``lg`` (B, S, V): argmax where the
        temperature is <= 0, else one draw from that row's generator."""
        lg = lg[:, -1].to(torch.float32, copy=True)
        lg[:, self.cfg.vocab:] = -1e30        # never emit padded-vocab ids
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        for i in np.flatnonzero(temps > 0.0):
            probs = torch.softmax(lg[i] / max(float(temps[i]), 1e-6), dim=-1)
            tok[i] = torch.multinomial(probs, 1, generator=gens[i])[0]
        return tok.cpu().numpy()

    # ------------------------------------------------------------- generate

    def generate(self, prompts: List[np.ndarray], max_new: int = 32,
                 temperature=None, eos_id=None, seeds=None,
                 strict: Optional[bool] = None) -> List[np.ndarray]:
        """Serve one static batch to completion (prompts left-padded to the
        longest).  Invalid prompts raise under ``strict`` and are SHED
        otherwise (empty output; their row decodes a dummy token)."""
        sc = self.sc
        strict = sc.strict if strict is None else strict
        B = len(prompts)
        self.last_results = None
        if B == 0:
            return []
        shed = {}
        if B > sc.max_batch:
            if strict:
                raise ValueError(f"{B} prompts exceed max_batch={sc.max_batch}; "
                                 "submit them through serve()")
            for i in range(sc.max_batch, B):
                shed[i] = f"{B} prompts exceed max_batch={sc.max_batch}"
            prompts = prompts[:sc.max_batch]
        work = [np.asarray(p, np.int32) for p in prompts]
        for i, p in enumerate(work):
            bad = ("prompt must be non-empty" if len(p) == 0 else
                   f"prompt length {len(p)} leaves no room to generate within "
                   f"max_seq={sc.max_seq}" if len(p) + 1 > sc.max_seq else None)
            if bad and strict:
                raise ValueError(bad)
            if bad:
                shed[i] = bad
                work[i] = np.array([1], np.int32)
        Bw = len(work)
        plen = max(len(p) for p in work)
        eos = _broadcast(sc.eos_id if eos_id is None else eos_id, Bw, np.int32,
                         "eos_id")
        temps = _broadcast(sc.temperature if temperature is None else temperature,
                           Bw, np.float32, "temperature")
        key_ids = list(range(Bw)) if seeds is None else list(seeds)
        gens = [self._generator(k) for k in key_ids]
        outs: List[np.ndarray]
        if max_new < 1:
            outs = [np.zeros(0, np.int32) for _ in range(B)]
        else:
            max_new = min(max_new, sc.max_seq - plen)
            toks = np.zeros((Bw, plen), np.int32)
            starts = np.zeros(Bw, np.int32)
            for i, p in enumerate(work):
                toks[i, plen - len(p):] = p
                starts[i] = plen - len(p)
            dev = self.device
            start = torch.as_tensor(starts, device=dev)
            cache = T.init_cache(self.cfg, Bw, sc.max_seq, device=dev)
            with torch.inference_mode():
                lg, cache = T.prefill(self.params, self.cfg,
                                      torch.as_tensor(toks, device=dev), cache, start)
                cur = self._sample(lg, temps, gens)
                emitted = []
                done = np.zeros(Bw, bool)
                for step in range(max_new):
                    emitted.append(cur)
                    done |= cur == eos
                    if done.all() or step == max_new - 1:
                        break
                    pos = torch.full((Bw,), plen + step, dtype=torch.int32, device=dev)
                    lg, cache = T.decode_step(
                        self.params, self.cfg, cache,
                        torch.as_tensor(cur[:, None], device=dev), pos, start)
                    cur = self._sample(lg, temps, gens)
            mat = np.stack(emitted, axis=1)
            outs = []
            for i in range(Bw):
                hits = np.flatnonzero(mat[i] == eos[i])
                end = hits[0] + 1 if hits.size else mat.shape[1]
                outs.append(np.zeros(0, np.int32) if i in shed
                            else mat[i, :end].astype(np.int32))
            outs += [np.zeros(0, np.int32)] * (B - Bw)
        res = []
        for i in range(B):
            if i in shed:
                res.append(ServeResult(i, outs[i], FinishReason.SHED, shed[i]))
            elif outs[i].size and outs[i][-1] == eos[i]:
                res.append(ServeResult(i, outs[i], FinishReason.EOS))
            else:
                res.append(ServeResult(i, outs[i], FinishReason.MAX_NEW))
        self.last_results = res
        return outs

    # --------------------------------------------------- continuous batching

    def _plan(self, r: Request) -> tuple:
        """Validate one request -> admission plan ``(P, start, budget)``."""
        sc = self.sc
        plen = len(r.tokens)
        if plen == 0:
            raise ValueError("prompt is empty")
        if plen + 1 > sc.max_seq:
            raise ValueError(f"prompt length {plen} cannot fit max_seq="
                             f"{sc.max_seq} with at least one new token")
        if r.max_new < 1:
            raise ValueError(f"max_new={r.max_new} < 1")
        budget = min(r.max_new, sc.max_seq - plen)
        P = _bucket(plen, sc.max_seq)
        if sc.max_seq - P < budget:
            P = plen
        return P, P - plen, budget

    def serve(self, requests: Sequence, max_new: int = 32,
              strict: Optional[bool] = None) -> List[np.ndarray]:
        """Serve a request stream with continuous batching on the engine's
        ``max_batch`` slots.  Returns outputs in request order;
        ``self.last_results`` carries a :class:`ServeResult` per request and
        ``self.last_serve_stats`` the scheduler's counters."""
        sc = self.sc
        strict = sc.strict if strict is None else strict
        reqs = [r if isinstance(r, Request)
                else Request(np.asarray(r, np.int32), max_new=max_new)
                for r in requests]
        n = len(reqs)
        if n == 0:
            return []
        def_temp = _broadcast(sc.temperature, n, np.float32, "temperature")
        def_eos = _broadcast(sc.eos_id, n, np.int32, "eos_id")
        results: dict = {}
        plans, queue = {}, collections.deque()
        for rid, r in enumerate(reqs):
            try:
                plans[rid] = self._plan(r)
                queue.append(rid)
            except ValueError as e:
                if strict:
                    raise ValueError(f"request {rid}: {e}") from None
                results[rid] = ServeResult(rid, np.zeros(0, np.int32),
                                           FinishReason.SHED, str(e))
        temp = [float(r.temperature) if r.temperature is not None else float(def_temp[i])
                for i, r in enumerate(reqs)]
        eos_r = [int(r.eos_id) if r.eos_id is not None else int(def_eos[i])
                 for i, r in enumerate(reqs)]
        gen_r = {rid: self._generator(reqs[rid].seed if reqs[rid].seed is not None
                                      else rid) for rid in queue}

        B, dev = sc.max_batch, self.device
        sched = Scheduler(B, 1)
        cache = T.init_cache(self.cfg, B, sc.max_seq, device=dev)
        mini = T.init_cache(self.cfg, 1, sc.max_seq, device=dev)
        pos = np.zeros(B, np.int32)
        start = np.zeros(B, np.int32)
        cur = np.zeros(B, np.int32)
        temps = np.zeros(B, np.float32)
        eos = np.full(B, -1, np.int32)
        gens: list = [None] * B
        stats = collections.Counter()

        def finish(rid, tokens, reason, detail=""):
            results[rid] = ServeResult(rid, np.asarray(tokens, np.int32), reason, detail)

        def evict(slot, reason, detail=""):
            rid = int(sched.slot_req[slot])
            finish(rid, sched.evict(slot), reason, detail)
            temps[slot] = 0.0

        with torch.inference_mode():
            while queue or sched.any_active:
                # admission into free slots, FIFO
                for slot in sched.free_slots():
                    if not queue:
                        break
                    slot, rid = int(slot), queue.popleft()
                    P, s0, budget = plans[rid]
                    toks = np.zeros((1, P), np.int32)
                    toks[0, s0:] = reqs[rid].tokens
                    for t in mini.values():
                        t.zero_()
                    lg, mini = T.prefill(self.params, self.cfg,
                                         torch.as_tensor(toks, device=dev), mini,
                                         torch.tensor([s0], dtype=torch.int32, device=dev))
                    stats["admissions"] += 1
                    if sc.health_checks and not bool(T.logits_health(self.cfg, lg)[0]):
                        stats["faults"] += 1
                        finish(rid, np.zeros(0, np.int32), FinishReason.FAULT,
                               "non-finite prefill logits quarantined")
                        continue
                    T.write_cache_slot(self.cfg, cache, mini, slot)
                    tok = int(self._sample(lg, np.asarray([temp[rid]], np.float32),
                                           [gen_r[rid]])[0])
                    pos[slot], start[slot], cur[slot] = P, s0, tok
                    temps[slot], eos[slot], gens[slot] = temp[rid], eos_r[rid], gen_r[rid]
                    sched.admit(slot, rid, budget)
                    if sched.record_one(slot, tok, eos_r[rid]):
                        evict(slot, FinishReason.EOS if tok == eos_r[rid]
                              else FinishReason.MAX_NEW)
                if not sched.any_active:
                    continue
                # ONE decode step for all slots at their own positions
                stats["decode_steps"] += 1
                stats["active_slot_steps"] += int(sched.active.sum())
                lg, cache, health = T.decode_step(
                    self.params, self.cfg, cache,
                    torch.as_tensor(cur[:, None], device=dev),
                    torch.as_tensor(pos, device=dev),
                    torch.as_tensor(start, device=dev), with_health=True)
                tok = self._sample(lg, np.where(sched.active, temps, 0.0), gens)
                healthy = health.cpu().numpy()
                np.minimum(pos + 1, sc.max_seq - 1, out=pos)
                cur = tok.copy()
                if sc.health_checks:
                    for slot in np.flatnonzero(sched.active & ~healthy):
                        stats["faults"] += 1
                        evict(int(slot), FinishReason.FAULT,
                              "non-finite logits quarantined mid-decode")
                for slot in sched.record(tok, eos):
                    evict(int(slot), FinishReason.EOS if tok[slot] == eos[slot]
                          else FinishReason.MAX_NEW)
        stats["slot_steps"] = stats["decode_steps"] * B
        self.last_serve_stats = dict(stats)
        self.last_results = [results[rid] for rid in range(n)]
        return [results[rid].tokens for rid in range(n)]
