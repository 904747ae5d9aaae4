"""Scheduler: the 95th percentile over the window relQueries' rows of the wait from the row's due time to its first token (wall clock)."""
from relbench.readers import percentile, window_rows


def read(run):
    waits = [r.first - r.due for r in window_rows(run) if r.first is not None]
    return percentile(waits, 0.95) if waits else None
