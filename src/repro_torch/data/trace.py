"""Serving-trace construction (paper §5.1): sample relQueries over datasets,
Poisson arrivals at a given rate, request counts uniform in [1, 100].
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.core.relquery import RelQuery, Request, make_relquery
from repro_torch.data.datasets import Dataset, make_dataset
from repro_torch.engine.tokenizer import HashTokenizer


@dataclass
class TraceConfig:
    num_relqueries: int = 100
    rate: float = 1.0                  # relQueries per second (Poisson)
    min_requests: int = 1
    max_requests: int = 100
    seed: int = 0
    output_len_jitter: float = 0.35    # EOS terminates before OL sometimes
    # Clamp on the per-template OL(R), applied at construction. Traces are
    # immutable once built (they may be shared between runs/replicas), so
    # drivers that need short outputs — e.g. real-JAX smoke mode keeping CPU
    # decoding affordable — set this instead of mutating built relQueries.
    output_token_cap: Optional[int] = None
    # Restrict template sampling to the dataset's first N templates — the
    # shared-template regime (many relQueries rendered from few templates)
    # that prefix-sharing-aware scheduling and routing target. None keeps the
    # full template set and the historical trace byte-identical.
    num_templates: Optional[int] = None
    # Fraction of each relQuery's rows replaced by *exact* copies of earlier
    # rows in the same window — the duplicate-heavy regime the planner's
    # dedup pass targets. A duplicate is request-identical: same rendered
    # prompt AND the same sampled sim_output_len (copied from its source), so
    # answering the leader once reproduces every duplicate's stream exactly.
    # Drawn from a derived RNG stream: at 0.0 nothing is drawn and the trace
    # is byte-identical to historical traces.
    dup_row_fraction: float = 0.0


def poisson_arrivals(n: int, rate: float, rng: random.Random) -> List[float]:
    t, out = 0.0, []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def build_trace(dataset: Dataset, cfg: TraceConfig,
                tokenizer: Optional[HashTokenizer] = None) -> List[RelQuery]:
    tokenizer = tokenizer or HashTokenizer()
    rng = random.Random(cfg.seed)
    arrivals = poisson_arrivals(cfg.num_relqueries, cfg.rate, rng)
    templates = dataset.templates if cfg.num_templates is None else \
        dataset.templates[:max(1, cfg.num_templates)]
    trace: List[RelQuery] = []
    for qi, arr in enumerate(arrivals):
        tpl = rng.choice(templates)
        n_req = rng.randint(cfg.min_requests, cfg.max_requests)
        offset = rng.randrange(0, max(1, len(dataset.table) - n_req))
        rows = dataset.table.rows[offset:offset + n_req]
        # duplicate-heavy synthesis: replace a fraction of the window with
        # copies of earlier rows (derived RNG — the main stream is untouched,
        # keeping 0.0 byte-identical to historical traces)
        dup_src: Dict[int, int] = {}
        if cfg.dup_row_fraction > 0 and len(rows) > 1:
            rows = list(rows)
            dup_rng = random.Random(
                zlib.crc32(f"dup:{cfg.seed}:{qi}".encode()))
            n_dup = int(round(cfg.dup_row_fraction * len(rows)))
            for _ in range(n_dup):
                dst = dup_rng.randrange(1, len(rows))
                src = dup_rng.randrange(0, dst)
                rows[dst] = rows[src]
                dup_src[dst] = src
        prompts = [tokenizer.encode(tpl.render(row)) for row in rows]
        ol = tpl.max_output_tokens
        if cfg.output_token_cap is not None:
            ol = max(1, min(ol, cfg.output_token_cap))
        rq = make_relquery(f"q{qi}", prompts, arr, ol,
                           template_id=tpl.template_id, eos_token=tokenizer.eos)
        # simulated actual output lengths (EOS can fire before the limit)
        for r in rq.requests:
            lo = max(1, int(ol * (1 - cfg.output_len_jitter)))
            r.sim_output_len = rng.randint(lo, ol)
        # duplicates are request-identical: copy the source row's sampled
        # length too (ascending dst order propagates through dup chains)
        for dst, src in sorted(dup_src.items()):
            rq.requests[dst].sim_output_len = rq.requests[src].sim_output_len
        trace.append(rq)
    return trace


def quick_trace(dataset_name: str = "rotten", num_relqueries: int = 20,
                rate: float = 1.0, seed: int = 0, num_rows: int = 2000,
                max_requests: int = 40) -> List[RelQuery]:
    ds = make_dataset(dataset_name, num_rows=num_rows, seed=seed)
    cfg = TraceConfig(num_relqueries=num_relqueries, rate=rate, seed=seed,
                      max_requests=max_requests)
    return build_trace(ds, cfg)
