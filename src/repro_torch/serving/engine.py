"""Continuous-batching serving engine over the paged KV pool — the
single-device subset of ``repro.serving.engine``.

Slot-based continuous batching: the decode batch has ``max_batch``
fixed slots; a request occupies one slot from prefill until EOS or its
token limit, then the slot is reusable.  Every layer's KV pool is
slot-partitioned (slot s owns pages ``[s*mps, (s+1)*mps)``).

Prefill is chunked and policy-driven (``core.scheduler.PrefillPolicy``):
each step admits at most one waiting request and spends up to the
policy's token budget advancing partially-prefilled slots by
page-aligned chunks (``Model.prefill_chunk`` -> the chunk-prefill
kernel).  A prompt that is one chunk runs whole (``Model.prefill`` ->
the flash kernel).  Decode runs every active slot in one batched step
(``Model.decode_step`` -> the paged-decode kernel over the pool in
place).  Greedy sampling is ``argmax``.

Where the reference extracts a batch-1 copy of a slot's cache and adopts
it back, the port computes on in-place slot VIEWS of the engine's
caches (``paged.pool.slot_view``): the same bytes land in the pool
without a copy.  Recurrent block kinds, meshes, live transformation,
merges and KV spill are not ported yet (ROADMAP queue 1 items 5-10).

``Engine(cfg)`` runs on the card.  Without a GPU it raises unless the
caller asks for ``device="cpu"``, where every kernel call runs its
plain PyTorch version.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, SLIDING, ModelConfig
from repro_torch.core.padding import make_plan
from repro_torch.core.scheduler import PrefillPolicy
from repro_torch.models import model as M
from repro_torch.models.blocks import _window_of
from repro_torch.paged import pool as pp
from repro_torch.serving.request import ServeRequest, State


def resolve_device(device) -> torch.device:
    """``None`` means the card.  A CUDA device without a GPU raises:
    the engine never drops quietly to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "Engine runs on the GPU by default and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Engine:
    def __init__(self, cfg: ModelConfig, params: Optional[M.Model] = None,
                 max_batch: int = 4, max_seq: int = 256,
                 page_tokens: int = 16, seed: int = 0,
                 prefill_policy: Optional[PrefillPolicy] = None,
                 device=None):
        """``params`` is a ``Model`` already on ``device``; without one
        the engine builds random weights from ``seed``.  The KV pools are
        header-centric (the kernels' canonical layout)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self._clock = time.monotonic
        self.plan = make_plan(cfg, 1)
        self.max_batch = max_batch
        self.max_seq_alloc = max_seq
        self.page_tokens = page_tokens
        if params is None:
            params = M.build(cfg, self.plan, seed, self.device)
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self.model = params
        # temperature sampling only: not comparable with the reference,
        # which samples with jax.random
        self.gen = torch.Generator(device="cpu")
        self.gen.manual_seed(seed)
        self.caches: List[pp.PagedState] = self.model.init_decode_caches(
            max_batch, max_seq, page_tokens)
        self.slots: List[Optional[ServeRequest]] = [None] * max_batch
        self.waiting: List[ServeRequest] = []
        self.prefill_policy = prefill_policy or PrefillPolicy()
        # slot -> {"req", "chunks", "ci", "done"}: the page-aligned chunk
        # plan and its progress (the KV lives in the slot's pool pages)
        self._prefilling: Dict[int, Dict] = {}
        self._prefill_deferred = 0   # consecutive decode-priority defers

    def _min_chunk_cap(self) -> int:
        """Largest chunk one prefill call may carry: the smallest
        attention-cache capacity across the model's layers (a ring's
        page-rounded window; ``max_seq_alloc`` for full attention)."""
        caps = []
        for k in set(self.cfg.pattern):
            if k in (ATTN, SLIDING):
                w = _window_of(k, self.cfg)
                cap = (self.max_seq_alloc if w == 0
                       else min(self.max_seq_alloc, w))
                caps.append(-(-cap // self.page_tokens) * self.page_tokens)
        return min(caps) if caps else self.max_seq_alloc

    # -- InstanceView accessors (no mesh) ---------------------------------
    def max_seq_at(self, tp: int) -> int:
        """Admission ceiling (tokens per request): a single-device engine
        has no transformable axis and exposes its allocation at any
        degree."""
        assert tp >= 1, tp
        return self.max_seq_alloc

    def max_seq(self) -> int:
        return self.max_seq_at(1)

    def kv_capacity_tokens(self) -> int:
        """Slot-partitioned pools: every slot owns max_seq() tokens."""
        return self.max_batch * self.max_seq()

    def kv_used_tokens(self) -> int:
        used = sum(r.context_len for r in self.slots if r is not None)
        return used + sum(len(r.prompt) for r in self.waiting)

    def kv_used_fraction(self) -> float:
        return self.kv_used_tokens() / max(self.kv_capacity_tokens(), 1)

    def kv_free_tokens(self) -> int:
        return max(0, self.kv_capacity_tokens() - self.kv_used_tokens())

    def load(self) -> float:
        # KV pressure + queue pressure, as the simulator's load
        return self.kv_used_fraction() + 0.05 * len(self.waiting)

    def has_long_request(self) -> bool:
        """A request is long if its final context would not fit this
        engine at TP1."""
        cap1 = self.max_seq_at(1)
        live = [r for r in self.slots if r is not None] + self.waiting
        return any(r.total_tokens > cap1 for r in live)

    # -- requests -----------------------------------------------------------
    def submit(self, req: ServeRequest) -> None:
        self.waiting.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def _n_decoding(self) -> int:
        return sum(1 for r in self.slots
                   if r is not None and r.state == State.DECODE)

    # -- slot views (the reference's extract / adopt) -----------------------
    def _slot_caches(self, slot: int) -> List[pp.PagedState]:
        """Batch-1 in-place views of ``slot`` in every layer's cache."""
        return [pp.slot_view(c, slot) for c in self.caches]

    # -- chunked prefill ----------------------------------------------------
    def _begin_prefill(self, req: ServeRequest, slot: int) -> None:
        req.state = State.PREFILL
        req.slot = slot
        self.slots[slot] = req
        chunks = self.prefill_policy.chunk_sizes(len(req.prompt),
                                                 self.page_tokens)
        if len(chunks) > 1:
            # ring-cache models: no chunk may exceed the smallest
            # attention capacity (a page multiple, so the page-boundary
            # chunking invariant survives the split)
            cap = self._min_chunk_cap()
            chunks = [s for c in chunks
                      for s in ([cap] * (c // cap) + ([c % cap] if c % cap
                                                      else []))]
        self._prefilling[slot] = {"req": req, "chunks": chunks, "ci": 0,
                                  "done": 0}

    def _prefill_step(self) -> int:
        """Admit at most one waiting request, then spend the policy's
        token quota advancing partially-prefilled slots in its service
        order.  Returns tokens emitted (a finished prefill emits the
        first token)."""
        if self.waiting:
            slot = self._free_slot()
            if slot is not None:
                self._begin_prefill(self.waiting.pop(0), slot)
        if not self._prefilling:
            self._prefill_deferred = 0
            return 0
        quota = self.prefill_policy.step_quota(self._n_decoding(),
                                               self._prefill_deferred)
        if quota <= 0:
            self._prefill_deferred += 1
            return 0
        self._prefill_deferred = 0
        emitted = 0
        spent = 0.0

        def remaining(slot: int) -> int:
            p = self._prefilling[slot]
            return len(p["req"].prompt) - p["done"]

        for slot in self.prefill_policy.service_order(
                list(self._prefilling), remaining):
            while slot in self._prefilling:
                prog = self._prefilling[slot]
                size = prog["chunks"][prog["ci"]]
                if spent > 0 and spent + size > quota:
                    return emitted      # budget exhausted this step
                emitted += self._run_chunk(slot)
                spent += size
        return emitted

    def _run_chunk(self, slot: int) -> int:
        """Advance the slot's prefill by one chunk; returns 1 when the
        prefill completed (first token emitted), else 0."""
        prog = self._prefilling[slot]
        req = prog["req"]
        if req.t_prefill_start is None:
            req.t_prefill_start = self._clock()
        if len(prog["chunks"]) == 1:
            self._prefill_whole(req, slot)
            del self._prefilling[slot]
            return 1
        start = prog["done"]
        size = prog["chunks"][prog["ci"]]
        tokens = torch.tensor(req.prompt[start:start + size],
                              dtype=torch.long, device=self.device)[None]
        start_a = torch.full((1,), start, dtype=torch.int32,
                             device=self.device)
        views = self._slot_caches(slot)
        self._sanitize_sub(views, start)
        logits = self.model.prefill_chunk(tokens, start_a, views,
                                          first_chunk=start == 0)
        prog["done"] += size
        prog["ci"] += 1
        if prog["done"] >= len(req.prompt):
            del self._prefilling[slot]
            self._finish_prefill(req, slot, logits)
            return 1
        return 0

    def _pin_prefill_cursors(self) -> None:
        """Decode iterations append masked filler for EVERY slot at its
        ``seq_lens`` cursor, mid-prefill slots included.  Re-pinning the
        cursor to ``done`` after each decode confines the filler to the
        one position the next chunk overwrites anyway (left alone, a
        starved slot's filler would ring-wrap into its prefix)."""
        if not self._prefilling:
            return
        idx = torch.tensor(sorted(self._prefilling), dtype=torch.long,
                           device=self.device)
        val = torch.tensor([self._prefilling[s]["done"]
                            for s in sorted(self._prefilling)],
                           dtype=torch.int32, device=self.device)
        for c in self.caches:
            c.seq_lens[idx] = val

    @staticmethod
    def _sanitize_sub(views: List[pp.PagedState], done: int) -> None:
        """Prepare a slot's views for the next chunk, in place: keep
        exactly the slots holding real prefix tokens (stored position in
        ``[0, done)``; decode filler past the prefix is re-invalidated)
        and set the cursor to ``done``.  Position-based, not slot-index
        based: on a ring cache prefix positions wrap around the slots."""
        for v in views:
            keep = (v.positions >= 0) & (v.positions < done)
            v.positions.masked_fill_(~keep, -1)
            v.seq_lens.fill_(done)

    def _sample(self, logits: torch.Tensor, temperature: float) -> int:
        """One token from one row of logits (vocab_padded,)."""
        if temperature <= 0.0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float().cpu() / temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    def _finish_prefill(self, req: ServeRequest, slot: int,
                        logits: torch.Tensor) -> None:
        tok = self._sample(logits[0, -1], req.temperature)
        req.generated.append(tok)
        req.t_first_token = self._clock()
        req.state = State.DECODE
        req.slot = slot
        self.slots[slot] = req
        # the prefill-emitted token counts against the budget too
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and tok == req.eos_id)
                or req.context_len >= self.max_seq_alloc):
            req.state = State.DONE
            req.t_done = self._clock()
            self.slots[slot] = None

    def _prefill_whole(self, req: ServeRequest, slot: int) -> None:
        """Single-call prefill straight into the slot's pages: every page
        of the slot's range is rewritten, exactly what the reference's
        fresh batch-1 cache + page-range adopt leaves there."""
        prompt = torch.tensor(req.prompt, dtype=torch.long,
                              device=self.device)[None]
        logits = self.model.prefill(prompt, self._slot_caches(slot))
        self._finish_prefill(req, slot, logits)

    # -- one engine iteration -----------------------------------------------
    @torch.no_grad()
    def step(self) -> Dict[str, int]:
        """One engine iteration: policy-driven prefill work, then one
        batched decode step for every decoding slot."""
        emitted = self._prefill_step()
        decode_emitted = 0
        active = [r for r in self.slots
                  if r is not None and r.state == State.DECODE]
        if active:
            tokens = np.zeros((self.max_batch,), np.int64)
            positions = np.zeros((self.max_batch,), np.int32)
            for r in active:
                tokens[r.slot] = r.generated[-1]
                positions[r.slot] = r.context_len - 1
            # one batched step over every slot: idle and prefilling rows
            # compute masked filler whose outputs are dropped
            logits = self.model.decode_step(
                self.caches, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(positions).to(self.device))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for r in active:
                tok = int(nxt[r.slot])
                if r.temperature > 0:
                    tok = self._sample(logits[r.slot], r.temperature)
                r.generated.append(tok)
                emitted += 1
                decode_emitted += 1
                if (len(r.generated) >= r.max_new_tokens
                        or (r.eos_id is not None and tok == r.eos_id)
                        or r.context_len >= self.max_seq_alloc):
                    r.state = State.DONE
                    r.t_done = self._clock()
                    self.slots[r.slot] = None
            self._pin_prefill_cursors()
        return {"active": len(active), "waiting": len(self.waiting),
                "emitted": emitted, "decode_emitted": decode_emitted}

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.waiting and all(s is None for s in self.slots):
                return
            self.step()
        raise RuntimeError("engine did not drain")
