"""End to end: the 95th percentile over the finished rows of the relQueries due in the window of the wall seconds from the row's due time to its last token."""
from relbench.readers import percentile, window_rows


def read(run):
    lat = [r.finish - r.due for r in window_rows(run) if r.finish is not None]
    return percentile(lat, 0.95) if lat else None
