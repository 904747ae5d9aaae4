"""End to end: the mean over the relQueries due in the window that finished of the wall seconds from the relQuery's due time to its last row's last token."""
import statistics

from relbench.readers import window_rows


def read(run):
    done, open_ = {}, set()
    for r in window_rows(run):
        if r.finish is None:
            open_.add(r.req.rel_id)
        else:
            done[r.req.rel_id] = max(done.get(r.req.rel_id, r.due), r.finish)
    due = {r.req.rel_id: r.due for r in window_rows(run)}
    lat = [t - due[k] for k, t in done.items() if k not in open_]
    return statistics.fmean(lat) if lat else None
