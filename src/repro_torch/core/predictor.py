"""Per-template output-length prediction (ALISE-style, PAPERS.md).

RelServe's relational workloads run one template over many rows, so finished
requests of a template are a strong predictor for the output length of the
template's remaining rows. ``OutputLenPredictor`` keeps a bounded window of
observed output lengths per template fingerprint and predicts a configurable
quantile — deterministic (pure sorted-window lookup, no RNG, no clocks) so
serial and pipelined engine loops see identical predictions at identical
observation histories.

Two consumers:

* ``kv_admission="predicted"`` — the scheduler admits on
  ``prompt + predicted_OL`` instead of the ``prompt + max_output`` worst case
  (preemption stays on as the safety valve for under-predictions).
* The DPU's remaining-work estimate (Eq. 9's ``pem``) — a waiting relQuery's
  expected decode work shrinks from ``OL(R)`` to the predicted length.

The pipelined engine loop speculates scheduler state one batch ahead;
speculative ``_finish_request`` calls feed the predictor projected lengths,
so the predictor journals observations between ``checkpoint()`` and
``rollback()``/``discard()`` exactly like the scheduler's ledger spec-log.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch.core.relquery import RelQuery


def template_fingerprint(rq: RelQuery, block_size: int = 16) -> int:
    """Stable identity of the shared prompt prefix of ``rq``'s requests: the
    template id when tagged, else the first prompt block of the first request
    (the rendered template head — what actually lands in the prefix cache).
    Used both for router prefix affinity and as the predictor's template key
    (deterministic across processes, unlike seed-randomized ``hash``)."""
    if rq.template_id:
        return zlib.crc32(rq.template_id.encode())
    if rq.requests:
        blk = rq.requests[0].tokens[:block_size]
        return zlib.crc32(b",".join(b"%d" % t for t in blk))
    return zlib.crc32(rq.rel_id.encode())


class OutputLenPredictor:
    """Running per-template quantile of observed output lengths.

    ``quantile=1.0`` predicts the window max (safest), ``0.5`` the median.
    The default 0.9 mirrors ALISE: rare long tails are absorbed by the
    preemption safety valve instead of inflating every admission.
    """

    def __init__(self, quantile: float = 0.9, window: int = 256):
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {quantile}")
        self.quantile = quantile
        self.window = window
        self._obs: Dict[int, List[int]] = {}
        self.observations = 0
        # open speculative journal: [(key, evicted_or_None), ...]
        self._journal: Optional[List[Tuple[int, Optional[int]]]] = None

    # ------------------------------------------------------------------ keys
    def key_of(self, rq: RelQuery) -> int:
        return template_fingerprint(rq)

    # ------------------------------------------------------------------ core
    def observe(self, key: int, output_len: int) -> None:
        lst = self._obs.setdefault(key, [])
        lst.append(int(output_len))
        evicted: Optional[int] = None
        if len(lst) > self.window:
            evicted = lst.pop(0)
        self.observations += 1
        if self._journal is not None:
            self._journal.append((key, evicted))

    def predict(self, key: int) -> Optional[int]:
        """Predicted output length for ``key``, or None with no history
        (callers fall back to the ``max_output`` worst case)."""
        lst = self._obs.get(key)
        if not lst:
            return None
        ordered = sorted(lst)
        idx = min(len(ordered) - 1,
                  max(0, int(self.quantile * len(ordered) + 0.999999) - 1))
        return ordered[idx]

    def predicted_remaining(self, key: int, produced: int) -> Optional[int]:
        """Output tokens a request of template ``key`` that has already
        produced ``produced`` tokens is still expected to emit — the
        remaining-work estimate proactive offload's idle horizon consumes.
        None with no history (callers fall back to ``remaining_output``).
        A request that outran its prediction clamps to 0: it is presumed
        near finish, so it is never an idle-tail victim on prediction
        grounds."""
        p = self.predict(key)
        if p is None:
            return None
        return max(0, p - produced)

    # ---------------------------------------------------- speculation support
    def checkpoint(self) -> None:
        self._journal = []

    def rollback(self) -> None:
        """Undo every observation since ``checkpoint()`` (newest first)."""
        journal = self._journal or []
        for key, evicted in reversed(journal):
            lst = self._obs[key]
            lst.pop()
            if evicted is not None:
                lst.insert(0, evicted)
            if not lst:
                del self._obs[key]
        self.observations -= len(journal)
        self._journal = None

    def discard(self) -> None:
        self._journal = None
