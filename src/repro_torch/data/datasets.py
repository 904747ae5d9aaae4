"""Synthetic dataset generators matched to the paper's Table 4 statistics.

The originals (Amazon reviews, Rotten Tomatoes, RateBeer, PDMX) are not
available offline, so we generate tables whose rendered-prompt token-length
distributions match the published averages, with realistic *value overlap*
(shared item descriptions across rows — several reviews of the same product)
so prefix-cache hit ratios land in the paper's ~38% regime (Fig. 4).
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.data.tables import Table
from repro_torch.data.templates import RelQueryTemplate, default_templates

# (avg prompt tokens, avg output tokens) per paper Table 4
DATASET_STATS: Dict[str, Tuple[int, int]] = {
    "amazon": (234, 18),
    "rotten": (215, 21),
    "beer": (174, 19),
    "pdmx": (158, 23),
}

_WORDS = [f"w{i:03d}" for i in range(800)]


def _sentence(rng: random.Random, n: int) -> str:
    return " ".join(rng.choice(_WORDS) for _ in range(n))


@dataclass
class Dataset:
    name: str
    table: Table
    templates: List[RelQueryTemplate]
    avg_output_tokens: int
    item_attr: str
    review_attr: str


def make_dataset(name: str, num_rows: int = 10_000, seed: int = 0,
                 items_per_catalog: int = 64) -> Dataset:
    """Rows reference a small catalog of shared item descriptions (value
    overlap) and carry unique review text (the uncached part)."""
    if name not in DATASET_STATS:
        raise KeyError(f"unknown dataset {name!r}; known: {list(DATASET_STATS)}")
    avg_in, avg_out = DATASET_STATS[name]
    rng = random.Random(seed ^ zlib.crc32(name.encode()))  # stable across processes
    # template overhead is ~25 words; split the rest between item (shared)
    # and review (unique) text, biased so shared prefixes are meaningful
    item_words = max(8, int(avg_in * 0.42))
    review_words = max(8, avg_in - item_words - 25)
    catalog = [_sentence(rng, max(4, int(rng.gauss(item_words, item_words * 0.25))))
               for _ in range(items_per_catalog)]
    rows = []
    for i in range(num_rows):
        rows.append({
            "item": rng.choice(catalog),
            "review": _sentence(rng, max(4, int(rng.gauss(review_words,
                                                          review_words * 0.3)))),
            "row_id": str(i),
        })
    table = Table(name, ["item", "review", "row_id"], rows)
    return Dataset(name, table, default_templates(name, "item", "review"),
                   avg_out, "item", "review")


ALL_DATASETS = tuple(DATASET_STATS)
