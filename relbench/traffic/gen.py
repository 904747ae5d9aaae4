"""The relQuery traffic generator, frozen for the benchmark.

A copy of the port's ``data/datasets.py``, ``data/templates.py``,
``data/trace.py`` and ``engine/tokenizer.py::HashTokenizer`` that imports
nothing of the port: synthetic tables matched to the paper's Table 4 prompt
and output statistics (amazon, rotten, beer, pdmx), the five query types of
Table 5 with their output limits, value overlap (rows share item
descriptions from a small catalog) and a whitespace hash tokenizer. Later
changes to the program's generator cannot move the yardstick.

What is new here is how a mix file turns into a run's traffic (``build``).
A mix fixes a *deck* from its own ``deck_seed``: the relQueries' shapes
(dataset, query type, row count), how many there are and when each is
due. A run's ``--seed`` draws the tables' text (and the prompts with it),
so every seed offers the same relQueries at the same times, with other
rows.
Each relQuery reads rows of its own: rows share item descriptions, never
whole rows. The result is plain data (token lists,
due times, output limits); the harness hands the prompts to the port's
``make_relquery`` at the boundary.
"""
from __future__ import annotations

import functools
import hashlib
import math
import random
import re
import zlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

# (avg prompt tokens, avg output tokens) per the paper's Table 4
DATASET_STATS: Dict[str, Tuple[int, int]] = {
    "amazon": (234, 18),
    "rotten": (215, 21),
    "beer": (174, 19),
    "pdmx": (158, 23),
}

# output-length limits per query type (paper §5.1)
OUTPUT_LIMITS = {
    "filter": 5,
    "classify": 10,
    "rating": 5,
    "summarize": 50,
    "open": 100,
}

_WORDS = [f"w{i:03d}" for i in range(800)]


# ------------------------------------------------------------------ tokenizer
class HashTokenizer:
    """Whitespace words to stable ids (blake2s), BOS first."""

    def __init__(self, vocab_size: int = 50_000, bos: int = 1, eos: int = 0):
        self.vocab_size = vocab_size
        self.bos = bos
        self.eos = eos

    @functools.lru_cache(maxsize=None)
    def _tok(self, word: str) -> int:
        h = int.from_bytes(hashlib.blake2s(word.encode(), digest_size=4).digest(),
                           "little")
        return 2 + h % (self.vocab_size - 2)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        toks = [self._tok(w) for w in text.split()]
        return ([self.bos] + toks) if add_bos else toks


# ------------------------------------------------------------------ templates
@dataclass(frozen=True)
class Template:
    template_id: str
    qtype: str
    text: str                   # {attr} placeholders

    @property
    def max_output_tokens(self) -> int:
        return OUTPUT_LIMITS[self.qtype]

    def render(self, row: Dict[str, str]) -> str:
        out = self.text
        for attr in re.findall(r"\{(\w+)\}", self.text):
            out = out.replace("{" + attr + "}", row[attr])
        return out


def default_templates(dataset: str, item_attr: str = "item",
                      review_attr: str = "review") -> Dict[str, Template]:
    """Five templates per dataset, by query type."""
    mk = lambda qt, text: Template(f"{dataset}/{qt}", qt, text)
    return {t.qtype: t for t in [
        mk("filter", "Decide whether this item is suitable for children based on the "
                     f"description {{{item_attr}}} . Answer yes or no only ."),
        mk("classify", "Categorize the sentiment of the review "
                       f"{{{review_attr}}} as Negative , Positive , or Neutral ."),
        mk("rating", "Predict the user's rating from 1 to 5 based on the item "
                     f"{{{item_attr}}} and the comment {{{review_attr}}} . "
                     "Output only the digit and nothing else ."),
        mk("summarize", f"Summarize the user's review {{{review_attr}}} on the item "
                        f"{{{item_attr}}} within 20 words ."),
        mk("open", "Who are the most likely audiences for this item given its "
                   f"description {{{item_attr}}} and a sample review {{{review_attr}}} ? "
                   "Explain briefly ."),
    ]}


# ------------------------------------------------------------------ tables
def _sentence(rng: random.Random, n: int) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n))


def make_table(name: str, num_rows: int, seed: int,
               items_per_catalog: int = 64) -> List[Dict[str, str]]:
    """Rows reference a small catalog of shared item descriptions (value
    overlap) and carry unique review text (the uncached part)."""
    avg_in, _ = DATASET_STATS[name]
    rng = random.Random(seed ^ zlib.crc32(name.encode()))
    # template overhead is ~25 words; split the rest between item (shared)
    # and review (unique) text, biased so shared prefixes are meaningful
    item_words = max(8, int(avg_in * 0.42))
    review_words = max(8, avg_in - item_words - 25)
    catalog = [_sentence(rng, max(4, int(rng.gauss(item_words, item_words * 0.25))))
               for _ in range(items_per_catalog)]
    return [{"item": rng.choice(catalog),
             "review": _sentence(rng, max(4, int(rng.gauss(review_words,
                                                           review_words * 0.3)))),
             "row_id": str(i)}
            for i in range(num_rows)]


# ------------------------------------------------------------------ traffic
@dataclass
class RelQuerySpec:
    """One relQuery as offered: its rows' prompt tokens, the query type's
    output limit, and the second (from the window's start) it is due."""
    rel_id: str
    dataset: str
    qtype: str
    prompts: List[List[int]]
    max_output_tokens: int
    due: float


def deck(mix: dict, count: int, part: str) -> List[Tuple[str, str, int]]:
    """``count`` relQuery shapes (dataset, query type, rows) of the mix,
    fixed by its ``deck_seed`` and ``part`` alone."""
    rng = random.Random(zlib.crc32(f"{part}:{mix['deck_seed']}".encode()))
    lo, hi = mix["rows"]
    return [(rng.choice(mix["datasets"]), rng.choice(mix["templates"]),
             rng.randint(lo, hi)) for _ in range(count)]


def arrivals(mix: dict, count: int, part: str, start: float,
             span: float) -> List[float]:
    """``count`` Poisson arrivals conditioned on their number in
    ``[start, start + span)``: sorted uniform times, fixed by the mix's
    ``deck_seed`` and ``part``."""
    rng = random.Random(zlib.crc32(f"due:{part}:{mix['deck_seed']}".encode()))
    return sorted(start + rng.uniform(0.0, span) for _ in range(count))


def build(mix: dict, seed: int, seconds: float, stream: str = "window",
          count: int = 0) -> List[RelQuerySpec]:
    """A run's relQueries (``stream`` names an independent draw and starts
    each rel_id).

    The shapes and due times are the mix's deck, the same for every seed;
    the seed draws the tables' text. ``count``: that many relQueries, all
    due at 0 (set-up's warm-up). Otherwise by the mix's driver.
    ``open_loop``: Poisson arrivals at the mix's rate, conditioned on their
    number: ``round(rate * seconds)`` in the window, then the drain's
    arrivals likewise over ``drain_s`` more seconds. ``backlog``: the mix's
    ``backlog_relqueries``, all due at 0."""
    rng = random.Random(zlib.crc32(f"{stream}:{seed}".encode()))
    if count:
        shapes, dues = deck(mix, count, "warmup"), [0.0] * count
    elif mix["driver"] == "open_loop":
        rate, drain = float(mix["rate_relq_per_s"]), float(mix["drain_s"])
        shapes, dues = [], []
        for part, n, lo, span in (("window", round(rate * seconds), 0.0, seconds),
                                  ("drain", math.ceil(rate * drain), seconds, drain)):
            shapes += deck(mix, n, part)
            dues += arrivals(mix, n, part, lo, span)
    else:
        n = int(mix["backlog_relqueries"])
        shapes, dues = deck(mix, n, "backlog"), [0.0] * n
    tok = HashTokenizer()
    # each dataset's table holds exactly the rows its relQueries read, each
    # relQuery its own run of them: rows share item descriptions (value
    # overlap), never whole rows (duplicates are another mix's)
    need: Dict[str, int] = {}
    for ds, _, n in shapes:
        need[ds] = need.get(ds, 0) + n
    tables = {ds: make_table(ds, need[ds], seed=rng.randrange(2 ** 32),
                             items_per_catalog=int(mix["items_per_catalog"]))
              for ds in sorted(need)}
    taken = {ds: 0 for ds in tables}
    out = []
    for i, ((ds, qtype, n), due) in enumerate(zip(shapes, dues)):
        rows = tables[ds][taken[ds]:taken[ds] + n]
        taken[ds] += n
        tpl = default_templates(ds)[qtype]
        prompts = [tok.encode(tpl.render(row)) for row in rows]
        out.append(RelQuerySpec(f"{stream}{i}", ds, qtype, prompts,
                                tpl.max_output_tokens, due))
    return out


def longest_row(mix: dict, seeds: Sequence[int], seconds: float) -> int:
    """Longest prompt plus output limit over the runs of ``seeds``."""
    return max(len(p) + rq.max_output_tokens
               for s in seeds for rq in build(mix, s, seconds)
               for p in rq.prompts)
