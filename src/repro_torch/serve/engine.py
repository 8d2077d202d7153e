"""Continuous-batching serve engine on dense KV slots or a paged,
prefix-shared block pool, with packed multi-prompt prefill.

Port of the reference package's ``serve/engine.py``: ``ServeConfig``,
``Request``, ``ServeResult``, ``FinishReason``, the ``Scheduler`` (with its
packing planner), the ``BlockAllocator`` and ``ServeEngine.generate`` /
``ServeEngine.serve``.

The engine owns ``B = ServeConfig.max_batch`` persistent decode SLOTS.  One
``decode_step`` serves all slots at their own positions through per-slot
``pos``/``start`` vectors.  A slot frees at its request's ``eos_id`` or
token budget.

Dense layout (``kv_layout="dense"``): one preallocated cache
``T.init_cache(cfg, B, max_seq)``.  A request is admitted into a free slot
by prefilling its prompt, left-padded to a power-of-two bucket, into a
fresh batch=1 cache and copying that into the slot; the other slots keep
decoding.

Paged layout (``kv_layout="paged"``): one block pool per layer
(``T.init_paged_cache``) and a host-side (B, max_blocks) block table; slot
b's logical row r lives in page ``table[b, r // block_size]``.  Admission
prefills the prompt unpadded at start 0, so a full block's rows are a pure
function of its prefix tokens; the :class:`BlockAllocator` maps the longest
registered prefix of full blocks (prefix sharing, refcounted), the prefill
runs from the first unshared token ``t0``, and the owned blocks are
written to fresh pages (a partly shared last block is copied, never
written in place).  A slot's table grows a block at a time as it decodes,
so the pool holds the tokens written, not ``max_seq`` per slot; eviction
drops the slot's references (registered prefix blocks park in an LRU list,
still matchable).  Decode reads the pages in place through K4.  Under
``numerics.kv_cache_format`` (rows rounded to a posit grid through K12)
no prefix is registered or matched: the pool pages without sharing.

Packed prefill (``packed_prefill=True``): each admission sweep groups the
queue head (one request per free slot) by bucket width and prefills each
group as ONE concatenated sequence with a block-diagonal segment mask
(K5), padded to a power-of-two count of segments with dummies; each
segment's rows and logits are those of its solo admission.  A segment whose
logits are not finite is quarantined (in the paged layout its rows go to
the block-0 sink and nothing of it is registered).  In the paged layout a
request whose prompt starts with an already registered prefix is admitted
solo, so that it prefills only its suffix (the reference packs it too and
recomputes the shared blocks); prompts sharing a prefix within one sweep
still pack together.

Batch invariance: a request's greedy tokens are the same bits solo,
admitted mid-flight next to other requests, packed, paged or sharing a
prefix.  Pad keys are masked, RoPE phases are relative to ``start``, the
flash kernels anchor their kv tiles at ``start`` (a packed segment at its
first key) and reduce each row in a fixed order with no atomics, and every
other op is row-wise.  On the CPU the tests hold it bit for bit.  On the
card, a run that gives the bf16 products other shapes (a static batch, a
paged admission's unpadded prompt, a suffix prefill, a pack) may see cuBLAS
pick another reduction order for them.  Sampled requests draw from a
generator of their own (seeded from ``ServeConfig.seed`` and the request's
key id), once per token, so their stream does not depend on the slot, the
pack or the step.

The dense and moe families serve from either layout, with solo or packed
admission, at every planned numerics.  The moe family's prefill is the
reference's scan: one decode step per prompt position, so that expert
capacity stays per token (a paged solo admission scans from ``t0``).  Its
packs lie on the batch axis: in the dense layout N left-padded rows of one width
prefilled together (the dummy rows, all-zero prompts at start 0, first),
each row copied into its slot; in the paged layout N right-padded rows at
start 0 (``T.prefill_batch_ragged``, each row's logits from its own last
step), each row's owned blocks scattered to their pages.

The hybrid family (RecurrentGemma) keeps a ring buffer of the local window
per attention layer and the RG-LRU state ``(conv, h)`` per recurrent layer
in each slot, so it has nothing to page: under ``kv_layout="paged"`` it
serves from dense slots, as the reference's engine does.  Its prefill is
the scan, and its packs lie on the batch axis as the moe family's in the
dense layout; a left-padded row's recurrent state stays at its init until
its prompt starts (``start``), so its tokens are those of its solo
admission.  The ssm family (Mamba2) keeps the SSD's conv window and state
``(conv, h)`` per layer in each slot, a constant size at any ``max_seq``,
and serves as the hybrid family does: from dense slots under either
layout, its prefill the scan, its packs on the batch axis.

The live session.  ``submit`` queues a request at any time, also while a
``serve_stream`` is being consumed; ``serve_stream`` drives the session and
yields a :class:`TokenEvent` per token and one :class:`FinishEvent` per
request, only at step boundaries (after the step's bookkeeping), so a
consumer may stop at any event and :meth:`ServeEngine.snapshot` there.
``serve`` is ``submit`` for each request and the stream drained.  Every
request ends with one :class:`ServeResult`: ``EOS``, ``MAX_NEW``,
``DEADLINE`` (``Request.deadline_ms`` from submission, or
``ServeConfig.max_queue_wait_ms`` while queued: checked once an admission
sweep and once a decode step, against the engine's injectable ``clock``),
``SHED`` (an invalid request, a submit past ``ServeConfig.max_queue``, a
paged request the pool can never hold; ``strict`` raises instead) or
``FAULT`` (the health probe found non-finite logits in its row, at
admission or mid-decode, before its token is recorded; a paged slot's
pages leave the prefix table).  Rows are independent, so a faulted or
expired request leaves every other request's tokens as they were.
``snapshot`` copies the session to host memory as one picklable dict (the
cache, the scheduler, the allocator, the mirrors, the per-request records,
the pending events and the state of every live request's generator);
``restore`` on an engine with the same model, weights and ServeConfig
finishes the stream with the same tokens.  Deadline clocks are kept as
elapsed time and rebased on restore.

Not ported yet (``ROADMAP.md``): ``warmup``, tensor-parallel meshes.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

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


def _pow2_ceil(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor) (pack-size bucketing)."""
    p = floor
    while p < n:
        p *= 2
    return p


class FinishReason(str, enum.Enum):
    """Terminal status of a served request."""

    EOS = "eos"            # sampled its eos_id
    MAX_NEW = "max_new"    # token budget exhausted
    DEADLINE = "deadline"  # deadline_ms / max_queue_wait_ms expired
    SHED = "shed"          # refused at admission (overflow / invalid)
    FAULT = "fault"        # non-finite logits quarantined


@dataclasses.dataclass
class ServeResult:
    """One request's terminal record: its (possibly empty or partial)
    tokens, and wall-clock milliseconds on the engine's clock from its
    submission (``ttft_ms`` None when it produced no token)."""

    rid: int
    tokens: np.ndarray
    finish: FinishReason
    detail: str = ""
    queue_wait_ms: float = 0.0
    ttft_ms: Optional[float] = None
    latency_ms: float = 0.0


#: The events :meth:`ServeEngine.serve_stream` yields.
TokenEvent = collections.namedtuple("TokenEvent", ("rid", "token"))
FinishEvent = collections.namedtuple("FinishEvent", ("rid", "result"))


@dataclasses.dataclass
class ServeConfig:
    """Engine limits + default sampling parameters (scalar or per request)."""

    max_batch: int = 8
    max_seq: int = 512
    temperature: Union[float, Sequence[float]] = 0.0  # 0 = greedy
    eos_id: Union[int, Sequence[int]] = -1            # -1 = never stop early
    seed: int = 0
    # "dense": per-slot (B, max_seq) cache regions; "paged": the refcounted
    # block pool with prefix sharing
    kv_layout: str = "dense"
    block_size: int = 16                 # pool page rows (power of two, 8..128)
    num_blocks: Optional[int] = None     # pool size; None = worst case + sink
    packed_prefill: bool = False         # pack each admission sweep
    max_queue: Optional[int] = None      # submit() backpressure bound
    max_queue_wait_ms: Optional[float] = None  # queue-wait deadline for all
    strict: bool = False                 # raise where a request would shed
    health_checks: bool = True           # non-finite logits quarantine

    @classmethod
    def from_model(cls, cfg: ModelConfig, **overrides) -> "ServeConfig":
        kw = dict(max_batch=cfg.serve_max_batch, max_seq=cfg.serve_max_seq)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass
class Request:
    """One generation request; ``None`` fields take the ServeConfig value,
    ``seed`` pins the sampling-key id (default: the request's index), and
    ``deadline_ms`` is a budget in milliseconds from submission (None: no
    deadline)."""

    tokens: np.ndarray
    max_new: int = 32
    temperature: Optional[float] = None
    eos_id: Optional[int] = None
    seed: Optional[int] = None
    deadline_ms: Optional[float] = None


class BlockAllocator:
    """Refcounted KV block pool with prefix-hash reuse (host-side).

    Owns the ids ``[1, num_blocks)`` of a paged cache's pool (block 0 is the
    parked-slot sink and is never handed out).  A block is **free** (on the
    free deque), **live** (``refcount > 0``, mapped by slot tables) or
    **cached** (refcount 0 but registered as a prefix block: parked in an
    LRU list, still matchable, reclaimed by :meth:`alloc` only when the
    free deque is empty).

    Prefix identity is a rolling chain hash over full token blocks, and every
    table entry keeps the FULL prefix tuple: a match requires tuple
    equality, so a hash collision can cost a lookup but never alias two
    prefixes (``hasher`` lets a test force collisions).
    """

    def __init__(self, num_blocks: int, block_size: int, hasher=None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (sink + 1), got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._hash = hash if hasher is None else hasher
        self.refcount = np.zeros(num_blocks, np.int64)
        self.free: collections.deque = collections.deque(range(1, num_blocks))
        self.cached: collections.OrderedDict = collections.OrderedDict()
        self.table: Dict[int, list] = {}   # chain hash -> [(prefix tuple, block)]
        self.owner: Dict[int, tuple] = {}  # registered block -> (hash, prefix)
        self.hits = 0      # match_prefix calls that shared >= 1 block
        self.lookups = 0

    def alloc(self) -> int:
        """A fresh block at refcount 1, reclaiming the LRU cached prefix
        block when the free deque is empty; ``ValueError`` when every block
        is live."""
        if self.free:
            bid = self.free.popleft()
        elif self.cached:
            bid, _ = self.cached.popitem(last=False)
            self._unregister(bid)
        else:
            raise ValueError(f"paged KV pool exhausted: all {self.num_blocks - 1} "
                             "usable blocks are mapped by live requests")
        self.refcount[bid] = 1
        return bid

    def incref(self, bid: int) -> None:
        self.refcount[bid] += 1
        self.cached.pop(bid, None)       # reactivated from the LRU park

    def decref(self, bid: int) -> None:
        assert self.refcount[bid] > 0, bid
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            if bid in self.owner:
                self.cached[bid] = None  # registered: park, stay matchable
            else:
                self.free.append(bid)

    def quarantine(self, bid: int) -> None:
        """Fault path (after the owning slot's decref): a parked registered
        block of a quarantined slot is unregistered and freed, so no future
        prefix match serves its possibly poisoned rows; a block still
        mapped elsewhere stays."""
        if self.refcount[bid] == 0 and bid in self.owner:
            self.cached.pop(bid, None)
            self._unregister(bid)
            self.free.append(bid)

    def blocks_in_use(self) -> int:
        return int((self.refcount > 0).sum())

    def _unregister(self, bid: int) -> None:
        h, _ = self.owner.pop(bid)
        bucket = self.table[h]
        bucket[:] = [e for e in bucket if e[1] != bid]
        if not bucket:
            del self.table[h]

    def _chain(self, tokens):
        """(chain hash, full prefix tuple, block index) per full block."""
        bs = self.block_size
        h = None
        for j in range(len(tokens) // bs):
            h = self._hash((h, tuple(tokens[j * bs:(j + 1) * bs])))
            yield h, tuple(tokens[:(j + 1) * bs]), j

    def _longest_chain(self, tokens) -> List[int]:
        shared: List[int] = []
        for h, full, _ in self._chain(tokens):
            bid = next((b for p, b in self.table.get(h, ()) if p == full), None)
            if bid is None:
                break
            shared.append(bid)
        return shared

    def match_prefix(self, tokens) -> List[int]:
        """The longest registered chain of full blocks for this prompt."""
        shared = self._longest_chain(tokens)
        self.lookups += 1
        self.hits += bool(shared)
        return shared

    def has_prefix(self, tokens) -> bool:
        """Does the prompt start with a registered full block?  (A look
        that leaves the hit counters alone.)"""
        return bool(self._longest_chain(tokens[:self.block_size]))

    def register_prefix(self, tokens, block_ids) -> None:
        """Publish this prompt's full-block chain.  First writer wins: a
        registered prefix keeps its page, and a registered block is never
        registered again."""
        for h, full, j in self._chain(tokens):
            bid = int(block_ids[j])
            bucket = self.table.setdefault(h, [])
            if any(p == full for p, _ in bucket) or bid in self.owner:
                continue
            bucket.append((full, bid))
            self.owner[bid] = (h, full)


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

    @staticmethod
    def plan_packs(head):
        """Packing planner: ``head`` is ``[(rid, key | None)]``, at most one
        queue entry per free slot in FIFO order (``None``: the entry cannot
        be packed).  Returns ``(packs, rest)``: ``[(key, [rids])]`` grouping
        same-key entries in first-seen order, and the unpackable rids in
        FIFO order."""
        packs: Dict = {}
        order: List = []
        rest: List[int] = []
        for rid, key in head:
            if key is None:
                rest.append(rid)
                continue
            if key not in packs:
                packs[key] = []
                order.append(key)
            packs[key].append(rid)
        return [(key, packs[key]) for key in order], rest

    @property
    def any_active(self) -> bool:
        return bool(self.active.any())


class _ServeState:
    """The engine's live session: everything it mutates between the first
    ``submit`` and the last ``FinishEvent``.  A submit to an idle (drained)
    engine starts a fresh one, so rids, and with them the default sampling
    key ids, start at 0 in each session.  ``init_cache=False`` leaves the
    big cache to :meth:`ServeEngine.restore`."""

    def __init__(self, eng: "ServeEngine", init_cache: bool = True):
        sc, dev = eng.sc, eng.device
        B = sc.max_batch
        # per request (index = rid)
        self.reqs: List[Request] = []
        self.plans: List[Optional[tuple]] = []   # (P, start, budget) | None
        self.req_temp: List[float] = []
        self.req_eos: List[int] = []
        self.req_gen: Dict[int, torch.Generator] = {}
        self.queue: collections.deque = collections.deque()
        self.pending: List = []                  # events awaiting the stream
        self.results: Dict[int, ServeResult] = {}
        self.t_submit: Dict[int, float] = {}     # ms on the engine's clock
        self.t_admit: Dict[int, float] = {}
        self.ttft: Dict[int, float] = {}         # ms durations
        self.ttfts: List[float] = []
        self.token_lats: List[float] = []
        # per slot: the host mirrors shipped to the device each step
        self.sched = Scheduler(B, 1)
        self.pos = np.zeros(B, np.int32)
        self.start = np.zeros(B, np.int32)
        self.cur = np.zeros(B, np.int32)
        self.temps = np.zeros(B, np.float32)
        self.eos = np.full(B, -1, np.int32)
        self.gens: list = [None] * B
        self.last_tok_ms = np.zeros(B, np.float64)
        self.stats = collections.Counter()
        self.cache = None
        if eng._paged:
            if init_cache:
                self.cache = T.init_paged_cache(eng.cfg, eng._num_blocks, sc.block_size,
                                                device=dev)
            self.alloc = BlockAllocator(eng._num_blocks, sc.block_size)
            self.bt_host = np.zeros((B, eng._max_blocks), np.int32)
            self.slot_blocks: List[List[int]] = [[] for _ in range(B)]
            self.peak_blocks = 0
        else:
            if init_cache:
                self.cache = T.init_cache(eng.cfg, B, sc.max_seq, device=dev)
            self.mini = T.init_cache(eng.cfg, 1, sc.max_seq, device=dev)

    @property
    def drained(self) -> bool:
        return not (self.pending or self.queue or self.sched.any_active)


class ServeEngine:
    """Greedy / temperature serving of a dense, moe, hybrid or ssm model on
    ``device``, over dense slots or a paged block pool
    (``ServeConfig.kv_layout``; the hybrid and ssm families always from
    dense slots),
    with solo or packed admission (``ServeConfig.packed_prefill``)."""

    def __init__(self, cfg: ModelConfig, params, sc: Optional[ServeConfig] = None,
                 device="cuda", clock: Optional[Callable[[], float]] = None):
        self.cfg = cfg
        self.params = params
        self.sc = sc = sc if sc is not None else ServeConfig.from_model(cfg)
        self.device = T.resolve_device(device)
        # an injectable clock in seconds, so that deadlines can be driven
        # without sleeping
        self._clock = time.monotonic if clock is None else clock
        self._st: Optional[_ServeState] = None
        self.last_results: Optional[List[ServeResult]] = None
        self.last_serve_stats: Optional[dict] = None
        if sc.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got {sc.kv_layout!r}")
        # the recurrent families keep state that does not grow with the
        # context: nothing to page, so they serve from dense slots under
        # either layout, as the reference's
        self._paged = sc.kv_layout == "paged" and cfg.family in ("dense", "moe")
        self._packed = bool(sc.packed_prefill)
        # prefix sharing needs a prefix's pages to be a pure function of its
        # tokens; under kv_cache_format the cache holds rounded rows, so the
        # pool pages without sharing, as the reference's engine does
        self._share = not cfg.numerics.kv_cache_format
        if self._paged:
            bs = sc.block_size
            if bs < 8 or bs > 128 or bs & (bs - 1):
                raise ValueError(f"block_size must be a power of two in [8, 128], got {bs}")
            if sc.max_seq % bs:
                raise ValueError(f"max_seq={sc.max_seq} must be a multiple of "
                                 f"block_size={bs} (the table's virtual length is "
                                 "the dense max_seq)")
            self._max_blocks = sc.max_seq // bs
            # worst case: every slot maps max_blocks pages of its own, + sink 0
            self._num_blocks = (sc.num_blocks if sc.num_blocks is not None
                                else sc.max_batch * self._max_blocks + 1)
            if self._num_blocks < 2:
                raise ValueError(f"num_blocks={self._num_blocks} < 2")

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

    def _now_ms(self) -> float:
        return self._clock() * 1e3

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
            bt = None
            with torch.inference_mode():
                lg, cache = T.prefill(self.params, self.cfg,
                                      torch.as_tensor(toks, device=dev), cache, start)
                if self._paged:
                    # the same dense prefill, laid out blockwise onto identity
                    # tables (left pads kept), then paged decode
                    mb = self._max_blocks
                    bt = torch.arange(1, Bw * mb + 1, dtype=torch.int32,
                                      device=dev).reshape(Bw, mb)
                    pool = T.init_paged_cache(self.cfg, Bw * mb + 1, sc.block_size,
                                              device=dev)
                    cache = T.scatter_dense_to_pool(self.cfg, pool, cache, bt)
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
                        torch.as_tensor(cur[:, None], device=dev), pos, start, bt)
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

    def serve_static(self, requests: Sequence, max_new: int = 32) -> List[np.ndarray]:
        """The static-batch baseline: requests in arrival order in groups of
        ``max_batch``, each group served by :meth:`generate` with the group's
        largest budget (a request stops early only at its own ``eos_id``).
        Per-request ``temperature``, ``eos_id`` and ``seed`` hold; per-request
        ``max_new`` does not."""
        reqs = [r if isinstance(r, Request)
                else Request(np.asarray(r, np.int32), max_new=max_new)
                for r in requests]
        n = len(reqs)
        def_temp = _broadcast(self.sc.temperature, n, np.float32, "temperature")
        def_eos = _broadcast(self.sc.eos_id, n, np.int32, "eos_id")
        outs: List[np.ndarray] = []
        for i in range(0, n, self.sc.max_batch):
            group = list(enumerate(reqs[i:i + self.sc.max_batch], start=i))
            outs += self.generate(
                [r.tokens for _, r in group], max_new=max(r.max_new for _, r in group),
                temperature=[r.temperature if r.temperature is not None else def_temp[j]
                             for j, r in group],
                eos_id=[r.eos_id if r.eos_id is not None else def_eos[j] for j, r in group],
                seeds=[r.seed if r.seed is not None else j for j, r in group])
        return outs

    # --------------------------------------------------- continuous batching

    def _plan(self, r: Request) -> tuple:
        """Validate one request -> admission plan ``(P, start, budget)``.
        A paged admission prefills unpadded at start 0 (``P`` = prompt
        length): prefix pages are then a pure function of the prefix."""
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
        if self._paged:
            return plen, 0, budget
        P = _bucket(plen, sc.max_seq)
        if sc.max_seq - P < budget:
            P = plen
        return P, P - plen, budget

    @staticmethod
    def _scalar_default(value, what: str, dtype):
        arr = np.asarray(value)
        if arr.ndim != 0:
            raise ValueError(f"a per-request ServeConfig {what} (a sequence) is resolved "
                             f"by stream index in serve(); submit() needs Request.{what} "
                             "or a scalar default")
        return dtype(arr)

    def _register(self, st: _ServeState, r: Request) -> int:
        """Append a request's records to the session; returns its rid."""
        rid = len(st.reqs)
        st.reqs.append(r)
        st.plans.append(None)
        st.req_temp.append(float(r.temperature) if r.temperature is not None
                           else self._scalar_default(self.sc.temperature, "temperature",
                                                     float))
        st.req_eos.append(int(r.eos_id) if r.eos_id is not None
                          else self._scalar_default(self.sc.eos_id, "eos_id", int))
        st.t_submit[rid] = self._now_ms()
        return rid

    def _finish(self, st: _ServeState, rid: int, tokens, reason: FinishReason,
                detail: str, now: float) -> ServeResult:
        t_sub = st.t_submit.get(rid, now)
        res = ServeResult(rid, np.asarray(tokens, np.int32), reason, detail,
                          queue_wait_ms=max(0.0, st.t_admit.get(rid, now) - t_sub),
                          ttft_ms=st.ttft.get(rid), latency_ms=max(0.0, now - t_sub))
        st.results[rid] = res
        return res

    def _shed(self, st: _ServeState, rid: int, detail: str) -> None:
        st.stats["shed"] += 1
        res = self._finish(st, rid, np.zeros(0, np.int32), FinishReason.SHED, detail,
                           self._now_ms())
        st.pending.append(FinishEvent(rid, res))

    def submit(self, request, max_new: int = 32, strict: Optional[bool] = None,
               _bounded: bool = True) -> int:
        """Queue one request on the live session and return its rid; also
        while a :meth:`serve_stream` is being consumed (it is admitted into
        the next free slot).  A submit to an idle engine starts a fresh
        session, with rids from 0.  An invalid request, or one past
        ``ServeConfig.max_queue`` queued requests, raises under ``strict``
        and is SHED otherwise (its FinishEvent comes out of the stream)."""
        sc = self.sc
        strict = sc.strict if strict is None else strict
        r = (request if isinstance(request, Request)
             else Request(np.asarray(request, np.int32), max_new=max_new))
        if self._st is None or self._st.drained:
            self._st = _ServeState(self)
        st = self._st
        try:
            plan = self._plan(r)
            if _bounded and sc.max_queue is not None and len(st.queue) >= sc.max_queue:
                raise ValueError(f"queue overflow: {len(st.queue)} requests already queued "
                                 f"(max_queue={sc.max_queue})")
        except ValueError as e:
            if strict:
                raise
            rid = self._register(st, r)
            self._shed(st, rid, str(e))
            return rid
        rid = self._register(st, r)
        st.plans[rid] = plan
        st.req_gen[rid] = self._generator(r.seed if r.seed is not None else rid)
        st.queue.append(rid)
        return rid

    def serve(self, requests: Sequence, max_new: int = 32,
              strict: Optional[bool] = None) -> List[np.ndarray]:
        """Serve a request stream with continuous batching on the engine's
        ``max_batch`` slots: :meth:`submit` for each request (exempt from
        ``max_queue``), then :meth:`serve_stream` drained.  Returns outputs
        in request order; ``self.last_results`` carries a
        :class:`ServeResult` per request and ``self.last_serve_stats`` the
        session's counters.  Sequence-valued ServeConfig defaults are
        resolved by stream index."""
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
        reqs = [dataclasses.replace(
                    r, temperature=(r.temperature if r.temperature is not None
                                    else float(def_temp[i])),
                    eos_id=r.eos_id if r.eos_id is not None else int(def_eos[i]))
                for i, r in enumerate(reqs)]
        if strict:
            for i, r in enumerate(reqs):       # the whole batch before any work
                try:
                    self._plan(r)
                except ValueError as e:
                    raise ValueError(f"request {i}: {e}") from None
        rids = [self.submit(r, strict=False, _bounded=False) for r in reqs]
        st = self._st
        for _ in self.serve_stream(strict=strict):
            pass
        self.last_results = [st.results[rid] for rid in rids]
        return [st.results[rid].tokens for rid in rids]

    def serve_stream(self, strict: Optional[bool] = None):
        """Drive the live session until it is drained, yielding
        :class:`TokenEvent` and :class:`FinishEvent` as they happen.

        Events are yielded only at step boundaries, after the step's
        bookkeeping (records, evictions, block releases); events a consumer
        never took stay in the session's ``pending`` buffer, so a snapshot
        taken at any yield re-delivers them.  Requests submitted between
        events are admitted into freed slots.  One consumer at a time; at
        the end ``self.last_serve_stats`` is set.

        Each pass: queued requests past their queue limit expire, then the
        packed admission sweep, then solo admission (a paged request that
        the pool can never hold sheds), then one decode step for all slots
        (the health quarantine before the step's tokens are recorded, the
        deadline sweep after)."""
        strict = self.sc.strict if strict is None else strict
        st = self._st
        if st is None:
            return
        while not st.drained:
            while st.pending:
                yield st.pending.pop(0)
            if st.drained:
                break
            with torch.inference_mode():
                self._expire_queued(st)
                self._admit(st, strict)
            while st.pending:
                yield st.pending.pop(0)
            if not st.sched.any_active:
                continue           # admitted requests may finish at their first token
            with torch.inference_mode():
                self._decode(st)
            while st.pending:
                yield st.pending.pop(0)
        self._finalize_stats(st)

    def _queue_limit(self, st: _ServeState, rid: int) -> Optional[float]:
        limits = [x for x in (st.reqs[rid].deadline_ms, self.sc.max_queue_wait_ms)
                  if x is not None]
        return min(limits) if limits else None

    def _expire_queued(self, st: _ServeState) -> None:
        """A queued request past its deadline or the queue-wait cap finishes
        DEADLINE without a slot."""
        if not st.queue:
            return
        now = self._now_ms()
        kept: collections.deque = collections.deque()
        for rid in st.queue:
            lim = self._queue_limit(st, rid)
            if lim is not None and now - st.t_submit[rid] > lim:
                st.stats["deadline_evictions"] += 1
                res = self._finish(st, rid, np.zeros(0, np.int32), FinishReason.DEADLINE,
                                   "expired while queued", now)
                st.pending.append(FinishEvent(rid, res))
            else:
                kept.append(rid)
        st.queue = kept

    def _admit(self, st: _ServeState, strict: bool) -> None:
        """The packed sweep, then solo admission into the free slots (FIFO;
        a paged admission waits on pool starvation for an eviction)."""
        if self._packed and st.queue:
            st.pending.extend(self._admit_packed_sweep(st))
        for slot in st.sched.free_slots():
            if not st.queue:
                break
            if not self._paged:
                st.pending.extend(self._admit_dense(st, int(slot), st.queue.popleft()))
                continue
            events = self._admit_paged(st, int(slot), st.queue[0])
            if events is not None:
                st.queue.popleft()
                st.pending.extend(events)
                continue
            if st.sched.any_active:
                break                  # deferred until an eviction frees blocks
            rid = st.queue.popleft()
            msg = (f"request {rid} needs more KV blocks than the pool can ever free "
                   f"(num_blocks={self._num_blocks}); raise ServeConfig.num_blocks")
            if strict:
                raise ValueError(msg)
            self._shed(st, rid, msg)

    # ----------------------------------------------------------- admission

    def _healthy(self, lg) -> np.ndarray:
        """(N,) bool: the rows of ``lg`` that pass the health probe."""
        if not self.sc.health_checks:
            return np.ones(lg.shape[0], bool)
        return T.logits_health(self.cfg, lg).cpu().numpy()

    def _prefill_forwards(self, width: int) -> int:
        """Forward passes of one prefill of prompts ``width`` positions wide:
        one for the dense family, one per position for the other families'
        scan."""
        return 1 if self.cfg.family == "dense" else width

    def _fault(self, st: _ServeState, rid: int) -> List:
        """An admission whose prefill logits are not finite: FAULT, no token."""
        now = self._now_ms()
        st.t_admit[rid] = now
        st.stats["faults"] += 1
        res = self._finish(st, rid, np.zeros(0, np.int32), FinishReason.FAULT,
                           "non-finite prefill logits quarantined", now)
        return [FinishEvent(rid, res)]

    def _admit_dense(self, st: _ServeState, slot: int, rid: int) -> List:
        """Solo admission into a dense slot: prefill the left-padded prompt
        into the zeroed batch=1 cache, copy it into the slot."""
        P, s0, budget = st.plans[rid]
        dev = self.device
        toks = np.zeros((1, P), np.int32)
        toks[0, s0:] = st.reqs[rid].tokens
        for t in T.cache_leaves(st.mini):
            t.zero_()
        lg, st.mini = T.prefill(self.params, self.cfg, torch.as_tensor(toks, device=dev),
                                st.mini, torch.tensor([s0], dtype=torch.int32, device=dev))
        st.stats["admissions"] += 1
        st.stats["prefill_forwards"] += self._prefill_forwards(P)
        if not self._healthy(lg)[0]:
            return self._fault(st, rid)
        T.write_cache_slot(self.cfg, st.cache, st.mini, slot)
        tok = int(self._sample(lg, np.asarray([st.req_temp[rid]], np.float32),
                               [st.req_gen[rid]])[0])
        return self._arm_slot(st, slot, rid, tok, P, s0, budget)

    def _map_blocks(self, st: _ServeState, rid: int):
        """The paged admission plan of one request: ``(shared, owned, t0,
        total)`` with the fully shared prefix blocks increfed and the owned
        ones allocated, or None (nothing held) when the pool cannot supply
        them.  ``t0`` leaves at least one token to prefill; a partly shared
        last block is recomputed into an owned page (copy-on-write)."""
        alloc, bs = st.alloc, self.sc.block_size
        plen = st.plans[rid][0]
        toks = tuple(int(t) for t in st.reqs[rid].tokens)
        shared = alloc.match_prefix(toks) if self._share else []
        t0 = min(len(shared) * bs, plen - 1)
        s_blk = t0 // bs
        total = -(-plen // bs)
        for b in shared[:s_blk]:
            alloc.incref(b)
        owned: List[int] = []
        try:
            for _ in range(total - s_blk):
                owned.append(alloc.alloc())
        except ValueError:
            for b in owned + shared[:s_blk]:
                alloc.decref(b)
            return None
        return shared[:-(-t0 // bs)], owned, t0, total

    def _map_slot(self, st: _ServeState, slot: int, rid: int, chain: List[int],
                  n_owned: int, t0: int) -> None:
        """Register a healthy paged admission's chain and map it to ``slot``."""
        plen = st.plans[rid][0]
        if self._share:
            st.alloc.register_prefix(tuple(int(t) for t in st.reqs[rid].tokens), chain)
        st.bt_host[slot, :] = 0
        st.bt_host[slot, :len(chain)] = chain
        st.slot_blocks[slot] = list(chain)
        st.stats["prefix_hit_tokens"] += t0
        st.stats["prefill_tokens"] += plen - t0
        st.stats["prompt_tokens"] += plen
        st.stats["owned_blocks"] += n_owned
        st.stats["shared_blocks"] += len(chain) - n_owned
        st.peak_blocks = max(st.peak_blocks, st.alloc.blocks_in_use())

    def _drop_blocks(self, st: _ServeState, owned: List[int], shared: List[int]) -> None:
        """Release a faulted admission's blocks; the shared prefix pages it
        read are suspect and leave the prefix table."""
        for b in owned:
            st.alloc.decref(b)
        for b in shared:
            st.alloc.decref(b)
            st.alloc.quarantine(b)

    def _admit_paged(self, st: _ServeState, slot: int, rid: int) -> Optional[List]:
        """Solo paged admission; its events, or None (nothing changed) when
        the pool cannot supply the blocks.  The shared prefix (and a partly
        shared copy-on-write source block) is gathered into a dense mini
        cache, the suffix from ``t0`` prefilled (K3 with ``q_offset = t0``;
        the moe family scans positions ``[t0, plen)``), the owned blocks
        written to their pages and the chain registered."""
        m = self._map_blocks(st, rid)
        if m is None:
            return None
        gathered, owned, t0, total = m
        plen, _, budget = st.plans[rid]
        dev, bs = self.device, self.sc.block_size
        s_blk = t0 // bs
        if t0:
            mini = T.mini_cache_with_prefix(self.cfg, st.cache, gathered, total * bs)
        else:
            mini = T.init_cache(self.cfg, 1, total * bs, device=dev)
        toks = torch.as_tensor(np.asarray(st.reqs[rid].tokens, np.int32)[None], device=dev)
        lg, mini = T.prefill(self.params, self.cfg, toks, mini,
                             torch.zeros(1, dtype=torch.int32, device=dev), t0)
        st.stats["admissions"] += 1
        st.stats["prefill_forwards"] += self._prefill_forwards(plen - t0)
        if not self._healthy(lg)[0]:
            self._drop_blocks(st, owned, gathered[:s_blk])
            return self._fault(st, rid)
        T.write_cache_blocks(self.cfg, st.cache, mini, owned, s_blk)
        self._map_slot(st, slot, rid, gathered[:s_blk] + owned, len(owned), t0)
        tok = int(self._sample(lg, np.asarray([st.req_temp[rid]], np.float32),
                               [st.req_gen[rid]])[0])
        return self._arm_slot(st, slot, rid, tok, plen, 0, budget)

    def _arm_slot(self, st: _ServeState, slot: int, rid: int, tok: int, P: int, s0: int,
                  budget: int) -> List:
        """Arm a slot with its already-sampled first token: the mirrors, the
        admission time and time to first token, the first TokenEvent (and
        the FinishEvent at once if that token finishes the request)."""
        st.pos[slot], st.start[slot], st.cur[slot] = P, s0, tok
        st.temps[slot], st.eos[slot] = st.req_temp[rid], st.req_eos[rid]
        st.gens[slot] = st.req_gen[rid]
        st.sched.admit(slot, rid, budget)
        now = self._now_ms()
        st.t_admit.setdefault(rid, now)
        st.ttft[rid] = now - st.t_submit.get(rid, now)
        st.ttfts.append(st.ttft[rid])
        st.last_tok_ms[slot] = now
        events: List = [TokenEvent(rid, tok)]
        if st.sched.record_one(slot, tok, st.req_eos[rid]):
            reason = FinishReason.EOS if tok == st.req_eos[rid] else FinishReason.MAX_NEW
            events.append(FinishEvent(rid, self._evict(st, slot, reason, "", now)))
        return events

    # ----------------------------------------------------- packed admission

    def _pack_key(self, st: _ServeState, rid: int) -> Optional[int]:
        """The packing bin (segment width) of a queued request, or None when
        it is admitted solo: its bucket fell back to the exact length, or
        (paged) its prompt starts with a registered prefix, whose solo
        admission prefills only the unshared suffix (a pack recomputes
        every segment whole).  Paged segments are rounded up to the block
        size, so each covers whole blocks."""
        if self._paged:
            P = _bucket(st.plans[rid][0], self.sc.max_seq)
            toks = tuple(int(t) for t in st.reqs[rid].tokens)
            if P & (P - 1) or st.alloc.has_prefix(toks):
                return None
            return max(P, self.sc.block_size)
        P = st.plans[rid][0]
        return None if P & (P - 1) else P

    def _admit_packed_sweep(self, st: _ServeState) -> List:
        """One packed admission sweep over the queue head (one entry per
        free slot); returns its events.  Unpackable entries, and those
        behind a pool starvation, stay queued for the solo loop or a later
        sweep."""
        free = st.sched.free_slots()
        n = min(len(free), len(st.queue))
        if n == 0:
            return []
        head = [(rid, self._pack_key(st, rid)) for rid in list(st.queue)[:n]]
        packs, _ = Scheduler.plan_packs(head)
        events: List = []
        admitted: set = set()
        si = 0
        for P, rids in packs:
            slots = [int(s) for s in free[si:si + len(rids)]]
            if self._paged:
                done, evs = self._admit_packed_paged(st, slots, rids, P)
            elif self.cfg.family == "dense":
                evs = self._admit_packed_dense(st, slots, rids, P)
                done = rids
            else:
                evs = self._admit_packed_batch(st, slots, rids, P)
                done = rids
            admitted.update(done)
            events.extend(evs)
            si += len(done)
            if len(done) < len(rids):
                break                # pool starvation: defer the rest
        if admitted:
            st.queue = collections.deque(r for r in st.queue if r not in admitted)
        return events

    def _pack_inputs(self, N: int, W: int):
        """Zeroed (1, N * W) token, segment-id (pads -1) and position arrays
        and the (N,) last-position vector of an N-segment pack of width W."""
        toks = np.zeros((1, N * W), np.int32)
        segs = np.full((1, N * W), -1, np.int32)
        pos = np.tile(np.arange(W, dtype=np.int32), N)[None]
        last = np.arange(1, N + 1, dtype=np.int32) * W - 1
        return toks, segs, pos, last

    def _prefill_pack(self, toks, segs, pos, last, W: int):
        dev = self.device
        N = len(last)
        mini = T.init_cache(self.cfg, 1, N * W, device=dev)
        t = lambda a: torch.as_tensor(a, device=dev)
        return T.prefill_packed(self.params, self.cfg, t(toks), mini, t(pos), t(segs),
                                t(last), W)

    def _prefill_ragged(self, toks, last):
        dev = self.device
        mini = T.init_cache(self.cfg, toks.shape[0], toks.shape[1], device=dev)
        t = lambda a: torch.as_tensor(a, device=dev)
        return T.prefill_batch_ragged(self.params, self.cfg, t(toks), mini,
                                      torch.zeros(toks.shape[0], dtype=torch.int32,
                                                  device=dev), t(last))

    def _admit_packed_dense(self, st: _ServeState, slots: List[int], rids: List[int],
                            P: int) -> List:
        """Dense-layout packed admission: the left-padded segments
        concatenated into one (1, N * P) sequence (N a power of two; the
        dummy segments come first and write the first real slot, which its
        real segment then overwrites), one K5 prefill, each segment copied
        into its slot."""
        N = _pow2_ceil(len(rids))
        nd = N - len(rids)
        toks, segs, pos, last = self._pack_inputs(N, P)
        slot_of = [slots[0]] * nd + list(slots)
        for j, rid in enumerate(rids):
            i, tk = nd + j, st.reqs[rid].tokens
            s0, off = P - len(tk), (nd + j) * P
            toks[0, off + s0:off + P] = tk
            segs[0, off + s0:off + P] = i
            pos[0, off:off + P] -= s0
        lg, mini = self._prefill_pack(toks, segs, pos, last, P)
        # a faulted segment's rows land in a slot that stays free; the next
        # admission there overwrites them all
        T.write_cache_slot_segments(self.cfg, st.cache, mini, slot_of, P)
        return self._finish_pack(st, slots, rids, nd, lg, 1)

    def _admit_packed_batch(self, st: _ServeState, slots: List[int], rids: List[int],
                            P: int) -> List:
        """Batch-axis packed admission (the scanned families, dense layout): the
        N left-padded prompts as the N rows of one (N, P) prefill (N a power
        of two; the dummy rows, all-zero prompts at start 0, come first and
        write the first real slot, which its real row then overwrites), each
        row copied into its slot.  Rows are independent, so each row's bits
        are its solo admission's."""
        dev = self.device
        N = _pow2_ceil(len(rids))
        nd = N - len(rids)
        toks = np.zeros((N, P), np.int32)
        starts = np.zeros(N, np.int32)
        slot_of = [slots[0]] * nd + list(slots)
        for j, rid in enumerate(rids):
            tk = st.reqs[rid].tokens
            toks[nd + j, P - len(tk):] = tk
            starts[nd + j] = P - len(tk)
        mini = T.init_cache(self.cfg, N, self.sc.max_seq, device=dev)
        lg, mini = T.prefill(self.params, self.cfg, torch.as_tensor(toks, device=dev), mini,
                             torch.as_tensor(starts, device=dev))
        T.write_cache_slots(self.cfg, st.cache, mini, slot_of)
        return self._finish_pack(st, slots, rids, nd, lg, self._prefill_forwards(P))

    def _finish_pack(self, st: _ServeState, slots: List[int], rids: List[int], nd: int,
                     lg, forwards: int) -> List:
        """Dense-layout pack tail: per-row health probe, one sample for the
        pack, each healthy request armed in its slot; returns the events."""
        healthy = self._healthy(lg)
        toks_s = self._sample_pack(st, rids, nd, lg)
        self._count_pack(st, len(rids), nd)
        st.stats["prefill_forwards"] += forwards
        events: List = []
        for j, rid in enumerate(rids):
            st.stats["admissions"] += 1
            if not healthy[nd + j]:
                events += self._fault(st, rid)
                continue
            P_, s0, budget = st.plans[rid]
            events += self._arm_slot(st, slots[j], rid, int(toks_s[nd + j]), P_, s0, budget)
        return events

    def _admit_packed_paged(self, st: _ServeState, slots: List[int], rids: List[int],
                            W: int):
        """Paged packed admission; returns ``(admitted rids, events)``.
        Blocks are mapped FIFO until the pool runs short (the rest stay
        queued).  Each segment is right-padded to the block-aligned width
        ``W`` at start 0 and recomputed whole (its shared prefix blocks are
        mapped, never written): the dense family's segments concatenated
        into one K5 prefill, the moe family's as the rows of one
        ``T.prefill_batch_ragged`` scan of W steps.  The owned blocks go to
        their pages in one scatter, a faulted segment's to the block-0 sink,
        and each healthy segment's chain is registered after the health
        probe, as a solo admission's."""
        bs = self.sc.block_size
        maps = []
        for rid in rids:
            m = self._map_blocks(st, rid)
            if m is None:
                break
            maps.append((rid,) + m)
        if not maps:
            return [], []
        N = _pow2_ceil(len(maps))
        nd = N - len(maps)
        if self.cfg.family == "dense":
            toks, segs, pos, last = self._pack_inputs(N, W)
            for j, (rid, *_) in enumerate(maps):
                i, tk = nd + j, st.reqs[rid].tokens
                toks[0, i * W:i * W + len(tk)] = tk
                segs[0, i * W:i * W + len(tk)] = i
                last[i] = i * W + len(tk) - 1
            lg, mini = self._prefill_pack(toks, segs, pos, last, W)
        else:
            toks = np.zeros((N, W), np.int32)
            last = np.zeros(N, np.int32)
            for j, (rid, *_) in enumerate(maps):
                tk = st.reqs[rid].tokens
                toks[nd + j, :len(tk)] = tk
                last[nd + j] = len(tk) - 1
            lg, mini = self._prefill_ragged(toks, last)
        st.stats["prefill_forwards"] += self._prefill_forwards(W)
        healthy = self._healthy(lg)
        bids = np.zeros((N, W // bs), np.int32)          # 0: the sink
        for j, (rid, gathered, owned, t0, total) in enumerate(maps):
            if healthy[nd + j]:
                bids[nd + j, t0 // bs:total] = owned
        T.scatter_segments_to_pool(self.cfg, st.cache, mini, bids, W)
        toks_s = self._sample_pack(st, [m[0] for m in maps], nd, lg)
        self._count_pack(st, len(maps), nd)
        events: List = []
        for j, (rid, gathered, owned, t0, total) in enumerate(maps):
            st.stats["admissions"] += 1
            s_blk = t0 // bs
            if not healthy[nd + j]:
                self._drop_blocks(st, owned, gathered[:s_blk])
                events += self._fault(st, rid)
                continue
            self._map_slot(st, slots[j], rid, gathered[:s_blk] + owned, len(owned), t0)
            plen, _, budget = st.plans[rid]
            events += self._arm_slot(st, slots[j], rid, int(toks_s[nd + j]), plen, 0, budget)
        return [m[0] for m in maps], events

    def _sample_pack(self, st: _ServeState, rids: List[int], nd: int, lg) -> np.ndarray:
        """One first-token sample for a whole pack: row ``nd + j`` with
        request ``rids[j]``'s temperature and generator, as its solo
        admission samples (dummy rows take argmax, which nothing reads)."""
        N = nd + len(rids)
        temps = np.zeros(N, np.float32)
        gens: list = [None] * N
        for j, rid in enumerate(rids):
            temps[nd + j], gens[nd + j] = st.req_temp[rid], st.req_gen[rid]
        return self._sample(lg, temps, gens)

    @staticmethod
    def _count_pack(st: _ServeState, n_real: int, nd: int) -> None:
        st.stats["packed_packs"] += 1
        st.stats["packed_segments"] += n_real
        st.stats["packed_dummies"] += nd

    # --------------------------------------------------------------- decode

    def _evict(self, st: _ServeState, slot: int, reason: FinishReason, detail: str,
               now: float) -> ServeResult:
        """Free a slot whose request finished; returns its result.  A FAULT
        also takes the slot's pages out of the prefix table."""
        rid = int(st.sched.slot_req[slot])
        out = st.sched.evict(slot)
        st.temps[slot] = 0.0
        st.gens[slot] = None
        if self._paged:
            self._release_blocks(st, slot, quarantine=reason is FinishReason.FAULT)
        return self._finish(st, rid, out, reason, detail, now)

    def _release_blocks(self, st: _ServeState, slot: int, quarantine: bool = False) -> None:
        """Drop an evicted slot's block references (a registered prefix block
        parks in the LRU list, an unregistered one frees) and zero its table
        row, so the parked slot writes the block-0 sink.  A FAULT eviction
        also unregisters the slot's now unmapped prefix blocks."""
        blocks = st.slot_blocks[slot]
        for b in blocks:
            st.alloc.decref(b)
        if quarantine:
            for b in blocks:
                st.alloc.quarantine(b)
        st.slot_blocks[slot] = []
        st.bt_host[slot, :] = 0

    def _decode(self, st: _ServeState) -> None:
        """ONE decode step for all slots at their own positions; its events
        go to ``st.pending``: the slots quarantined by the health probe
        (before their token is recorded), the step's tokens, the requests
        it finished, then those past their deadline (after the record, so
        the step's token is part of the partial output)."""
        sc, dev, sched = self.sc, self.device, st.sched
        st.stats["decode_steps"] += 1
        st.stats["active_slot_steps"] += int(sched.active.sum())
        bt = None
        if self._paged:
            # grow each active slot's table before the row it writes crosses
            # into an unmapped block (the default pool never runs short)
            for slot in np.flatnonzero(sched.active):
                need = int(st.pos[slot]) // sc.block_size
                if need >= len(st.slot_blocks[slot]):
                    b = st.alloc.alloc()
                    st.slot_blocks[slot].append(b)
                    st.bt_host[slot, need] = b
                    st.peak_blocks = max(st.peak_blocks, st.alloc.blocks_in_use())
            bt = torch.as_tensor(st.bt_host, device=dev)
        lg, st.cache, health = T.decode_step(
            self.params, self.cfg, st.cache, torch.as_tensor(st.cur[:, None], device=dev),
            torch.as_tensor(st.pos, device=dev), torch.as_tensor(st.start, device=dev),
            bt, with_health=True)
        tok = self._sample(lg, np.where(sched.active, st.temps, 0.0), st.gens)
        healthy = health.cpu().numpy()
        np.minimum(st.pos + 1, sc.max_seq - 1, out=st.pos)
        st.cur = tok.copy()
        now = self._now_ms()
        emit = st.pending.append
        if sc.health_checks:
            for slot in np.flatnonzero(sched.active & ~healthy):
                rid = int(sched.slot_req[slot])
                st.stats["faults"] += 1
                emit(FinishEvent(rid, self._evict(st, int(slot), FinishReason.FAULT,
                                                  "non-finite logits quarantined mid-decode",
                                                  now)))
        act = np.flatnonzero(sched.active)
        finished = sched.record(tok, st.eos)
        for slot in act:
            if st.last_tok_ms[slot] > 0:
                st.token_lats.append(now - st.last_tok_ms[slot])
            st.last_tok_ms[slot] = now
            emit(TokenEvent(int(sched.slot_req[slot]), int(tok[slot])))
        for slot in finished:
            rid = int(sched.slot_req[slot])
            reason = FinishReason.EOS if tok[slot] == st.eos[slot] else FinishReason.MAX_NEW
            emit(FinishEvent(rid, self._evict(st, int(slot), reason, "", now)))
        for slot in np.flatnonzero(sched.active):
            rid = int(sched.slot_req[slot])
            dl = st.reqs[rid].deadline_ms
            if dl is not None and now - st.t_submit[rid] > dl:
                st.stats["deadline_evictions"] += 1
                emit(FinishEvent(rid, self._evict(st, int(slot), FinishReason.DEADLINE,
                                                  "deadline exceeded mid-decode", now)))

    def _finalize_stats(self, st: _ServeState) -> None:
        sc = self.sc
        stats = {k: st.stats[k] for k in ("admissions", "prefill_forwards", "decode_steps",
                                          "active_slot_steps", "faults", "shed",
                                          "deadline_evictions", "packed_packs",
                                          "packed_segments", "packed_dummies")}
        stats.update(slot_steps=stats["decode_steps"] * sc.max_batch,
                     kv_layout="paged" if self._paged else "dense",
                     packed_prefill=self._packed,
                     requests=len(st.reqs),
                     finish_reasons=collections.Counter(r.finish.value
                                                        for r in st.results.values()),
                     ttft_ms=list(st.ttfts), token_latency_ms=list(st.token_lats))
        if self._paged:
            prompt = st.stats["prompt_tokens"]
            stats.update({
                "block_size": sc.block_size,
                "pool_blocks": self._num_blocks - 1,
                "peak_blocks_in_use": st.peak_blocks,
                "prompt_tokens": prompt,
                "prefill_tokens": st.stats["prefill_tokens"],
                "prefix_hit_tokens": st.stats["prefix_hit_tokens"],
                "prefix_hit_rate": st.stats["prefix_hit_tokens"] / max(prompt, 1),
                "owned_blocks": st.stats["owned_blocks"],
                "shared_blocks": st.stats["shared_blocks"],
                "prefix_lookups": st.alloc.lookups,
                "prefix_matches": st.alloc.hits,
            })
        self.last_serve_stats = stats

    # --------------------------------------------------- snapshot / restore

    _MIRRORS = ("pos", "start", "cur", "temps", "eos")
    _SCHED = ("active", "slot_req", "out_buf", "out_len", "budget")

    def snapshot(self) -> dict:
        """The live session as one picklable dict, in host memory: the cache,
        the scheduler, the allocator, the per-slot mirrors, the per-request
        records, the pending events and ``get_state()`` of every queued or
        active request's generator.  Times are kept as elapsed milliseconds,
        so :meth:`restore` rebases them on its engine's clock."""
        st = self._st
        if st is None:
            raise ValueError("no serve session to snapshot")
        sc, sched = self.sc, st.sched
        now = self._now_ms()
        live = list(st.queue) + [int(r) for r in sched.slot_req[sched.active]]
        snap = {
            "version": 1,
            "kv_layout": sc.kv_layout,
            "packed_prefill": self._packed,
            "max_batch": sc.max_batch,
            "max_seq": sc.max_seq,
            "device_type": self.device.type,
            "reqs": [dataclasses.replace(r, tokens=np.array(r.tokens, np.int32))
                     for r in st.reqs],
            "plans": list(st.plans),
            "req_temp": list(st.req_temp),
            "req_eos": list(st.req_eos),
            "gen_state": {rid: st.req_gen[rid].get_state() for rid in live},
            "queue": list(st.queue),
            "pending": list(st.pending),
            "results": dict(st.results),
            "submit_elapsed_ms": {r: now - t for r, t in st.t_submit.items()},
            "admit_elapsed_ms": {r: now - t for r, t in st.t_admit.items()},
            "ttft": dict(st.ttft),
            "ttfts": list(st.ttfts),
            "token_lats": list(st.token_lats),
            "sched": {k: getattr(sched, k).copy() for k in self._SCHED},
            "mirrors": {k: getattr(st, k).copy() for k in self._MIRRORS},
            "last_tok_elapsed_ms": np.where(st.last_tok_ms > 0, now - st.last_tok_ms, 0.0),
            "counters": dict(st.stats),
            "cache": T.map_cache(lambda v: v.to("cpu", copy=True), st.cache),
        }
        if self._paged:
            a = st.alloc
            snap["bt_host"] = st.bt_host.copy()
            snap["slot_blocks"] = [list(b) for b in st.slot_blocks]
            snap["peak_blocks"] = st.peak_blocks
            snap["alloc"] = {"refcount": a.refcount.copy(), "free": list(a.free),
                             "cached": list(a.cached), "owner": dict(a.owner),
                             "table": {h: list(v) for h, v in a.table.items()},
                             "hits": a.hits, "lookups": a.lookups}
        return snap

    def restore(self, snap: dict) -> None:
        """Rebuild the session of :meth:`snapshot` on this engine, which must
        have the snapshotting engine's model, weights and ServeConfig (the
        caller's contract; a different layout, ``max_batch`` or ``max_seq``
        is refused, as is a snapshot from another device type, whose
        generators draw other streams).  The rest of the stream then gives
        the uninterrupted stream's tokens."""
        sc = self.sc
        if (snap.get("kv_layout"), snap.get("max_batch"), snap.get("max_seq")) != (
                sc.kv_layout, sc.max_batch, sc.max_seq):
            raise ValueError(
                f"snapshot layout ({snap.get('kv_layout')}, max_batch="
                f"{snap.get('max_batch')}, max_seq={snap.get('max_seq')}) does not match "
                f"this engine ({sc.kv_layout}, max_batch={sc.max_batch}, "
                f"max_seq={sc.max_seq})")
        if snap.get("device_type") != self.device.type:
            raise ValueError(f"snapshot taken on a {snap.get('device_type')} device does not "
                             f"match this engine's {self.device.type} device: their sampling "
                             "generators draw different streams")
        st = _ServeState(self, init_cache=False)
        now = self._now_ms()
        st.reqs = list(snap["reqs"])
        st.plans = list(snap["plans"])
        st.req_temp = list(snap["req_temp"])
        st.req_eos = list(snap["req_eos"])
        for rid, state in snap["gen_state"].items():
            g = torch.Generator(device=self.device)
            g.set_state(state)
            st.req_gen[rid] = g
        st.queue = collections.deque(snap["queue"])
        st.pending = list(snap["pending"])
        st.results = dict(snap["results"])
        st.t_submit = {r: now - e for r, e in snap["submit_elapsed_ms"].items()}
        st.t_admit = {r: now - e for r, e in snap["admit_elapsed_ms"].items()}
        st.ttft = dict(snap["ttft"])
        st.ttfts = list(snap["ttfts"])
        st.token_lats = list(snap["token_lats"])
        sd = snap["sched"]
        st.sched = Scheduler(sc.max_batch, sd["out_buf"].shape[1])
        for k in self._SCHED:
            setattr(st.sched, k, sd[k].copy())
        for k in self._MIRRORS:
            setattr(st, k, snap["mirrors"][k].copy())
        for slot in np.flatnonzero(st.sched.active):
            st.gens[slot] = st.req_gen[int(st.sched.slot_req[slot])]
        el = np.asarray(snap["last_tok_elapsed_ms"], np.float64)
        st.last_tok_ms = np.where(el > 0, now - el, 0.0)
        st.stats = collections.Counter(snap["counters"])
        st.cache = T.map_cache(lambda v: v.to(self.device, copy=True), snap["cache"])
        if self._paged:
            st.bt_host = snap["bt_host"].copy()
            st.slot_blocks = [list(b) for b in snap["slot_blocks"]]
            st.peak_blocks = snap["peak_blocks"]
            sa, a = snap["alloc"], st.alloc
            a.refcount = sa["refcount"].copy()
            a.free = collections.deque(sa["free"])
            a.cached = collections.OrderedDict((b, None) for b in sa["cached"])
            a.table = {h: list(v) for h, v in sa["table"].items()}
            a.owner = dict(sa["owner"])
            a.hits, a.lookups = sa["hits"], sa["lookups"]
        self._st = st
