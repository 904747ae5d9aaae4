"""What the rate sweep and the limit readings share: the checkout on the
path, and one JSON line per reading."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def start() -> float:
    """Put the checkout on the path; returns the process clock's zero."""
    t0 = time.perf_counter()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    return t0


def emit(out, rec: dict) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if out is not None:
        out.write(line + "\n")
        out.flush()
