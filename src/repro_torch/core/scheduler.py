"""Chunked-prefill policy: the one piece of the reference's
``core/scheduler.py`` the single-device engine needs (``PrefillPolicy``
and ``MAX``), copied so the port stays free of JAX.  The §5 scheduler
(Algorithms 1 and 2, the ``InstanceView`` protocol) is ported with the
control plane later."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

MAX = float("inf")


# --------------------------------------------------------------------------
# Chunked-prefill policy (shared verbatim by the live engine and the sim)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class PrefillPolicy:
    """Token-budgeted chunked prefill with an explicit prefill/decode
    priority (the LoongServe / Sarathi-style scheduling layer under the
    §5 scheduler).

    ONE policy object drives both planes: ``serving.engine.Engine``
    consumes ``chunk_sizes`` + ``step_quota`` per engine step, and
    ``cluster_sim.SimInstance`` consumes the same methods (aggregated
    over the engine steps a tick models via ``tokens_over_steps``), so
    simulated TTFT/queue-delay behavior is policy-identical to live.

    * ``token_budget`` — prefill tokens an engine step may process
      (``None`` = unbounded: classic whole-prompt prefill);
    * ``mode`` — who wins when prefill work and active decodes compete:

        - ``"prefill"``: prefill first; decodes effectively wait behind
          prompt processing (vLLM's legacy prefill-prioritized step);
        - ``"decode"``:  active decodes run every step; prefill is
          deferred while any request is decoding, but never more than
          ``max_defer_steps`` consecutive steps (bounded starvation);
        - ``"mixed"``:   every step carries up to ``token_budget``
          prefill tokens alongside the decodes (Sarathi-style
          chunked-prefill piggybacking);

    * ``long_threshold`` — chunking is MANDATORY above this many prompt
      tokens even when ``token_budget`` is None: one monolithic prefill
      of a paper-Fig.-2 long prompt is exactly the head-of-line stall
      this policy exists to remove;
    * ``order`` — which partially-prefilled request gets budget first:
      ``"fcfs"`` (arrival order) or ``"sjf"`` (fewest remaining prompt
      tokens first — short prompts slip between a long prompt's chunks,
      which is what fixes burst TTFT p99).

    Chunk boundaries are PAGE boundaries (``chunk_sizes``): a partially
    prefilled slot is always a whole number of full pages plus at most
    one trailing partial page written by the final chunk, so
    ``copy_page_slices`` migration and transform sessions remain valid
    mid-prefill.
    """

    token_budget: Optional[int] = None
    mode: str = "prefill"            # "prefill" | "decode" | "mixed"
    long_threshold: int = 4096
    max_defer_steps: int = 4
    order: str = "fcfs"              # "fcfs" | "sjf"

    def effective_chunk(self, page_tokens: int) -> Optional[int]:
        """Largest chunk this policy emits (page-aligned ``token_budget``
        rounded down, never below one page), or None when unbudgeted
        (the ``long_threshold`` mandate still applies)."""
        if self.token_budget is None:
            return None
        return max(page_tokens,
                   self.token_budget - self.token_budget % page_tokens)

    def chunk_sizes(self, prompt_len: int, page_tokens: int) -> List[int]:
        """Partition ``prompt_len`` into prefill chunks.

        Invariants (property-tested in tests/test_scheduler.py):
        the chunks sum to ``prompt_len`` exactly; every chunk except the
        last is a whole number of pages; no chunk exceeds
        ``effective_chunk`` (when budgeted) nor the page-aligned
        ``long_threshold`` (when the prompt is long)."""
        assert prompt_len >= 0 and page_tokens >= 1
        if prompt_len == 0:
            return []
        limit = self.effective_chunk(page_tokens)
        if prompt_len > self.long_threshold:
            # chunking mandatory for long prompts, budget or not
            mandatory = max(page_tokens, self.long_threshold
                            - self.long_threshold % page_tokens)
            limit = mandatory if limit is None else min(limit, mandatory)
        if limit is None or prompt_len <= limit:
            return [prompt_len]
        n_full, rem = divmod(prompt_len, limit)
        return [limit] * n_full + ([rem] if rem else [])

    def step_quota(self, decoding: int, deferred_steps: int) -> float:
        """Prefill tokens permitted THIS engine step, given ``decoding``
        active decode requests and ``deferred_steps`` consecutive steps
        prefill work has already been deferred.  ``inf`` = unbounded."""
        budget = MAX if self.token_budget is None else self.token_budget
        if self.mode == "decode" and decoding > 0 \
                and deferred_steps < self.max_defer_steps:
            return 0.0
        return float(budget)

    def tokens_over_steps(self, decoding: int, steps: int,
                          deferred: int = 0) -> Tuple[float, int]:
        """Prefill tokens ``steps`` consecutive engine steps admit — the
        sim's per-tick aggregate of ``step_quota`` (literally the same
        decision function live engines run, summed).

        ``deferred`` is the caller's carried consecutive-deferral count
        and the updated count is returned alongside the total: the
        bounded-starvation guarantee of decode-priority spans tick
        boundaries only if the caller persists it (a tick that models
        fewer than ``max_defer_steps`` steps would otherwise defer
        forever)."""
        total = 0.0
        for _ in range(max(steps, 0)):
            q = self.step_quota(decoding, deferred)
            if q <= 0:
                deferred += 1
            else:
                deferred = 0
                total += q
        return total, deferred

    def decode_share(self, prefill_fraction: float) -> float:
        """Fraction of an instance's decode rate that survives while a
        ``prefill_fraction`` of its compute is prefilling — the sim's
        head-of-line model.  Prefill-priority stalls decodes behind the
        prompt (the classic whole-prompt pathology); decode-priority
        protects them fully; mixed splits the difference."""
        f = min(max(prefill_fraction, 0.0), 1.0)
        if self.mode == "prefill":
            return 1.0 - f
        if self.mode == "mixed":
            return 1.0 - 0.5 * f
        return 1.0

    def service_order(self, items: List, remaining_of) -> List:
        """Order partially-prefilled requests for budget service:
        ``remaining_of(item)`` -> outstanding prompt tokens."""
        if self.order == "sjf":
            return sorted(items, key=remaining_of)
        return list(items)

    def chunkable(self, prompt_len: int, page_tokens: int = 1) -> bool:
        """True iff this policy splits ``prompt_len`` into more than one
        chunk — the mid-transform-session admission predicate BOTH
        planes apply (``Engine._admittable_now`` and the simulator's
        tick): a whole-prompt prefill cannot interleave with schedule
        steps, so single-chunk prompts wait for the session to drain."""
        return len(self.chunk_sizes(prompt_len, page_tokens)) > 1
