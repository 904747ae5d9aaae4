"""Executor: the window's prefill seconds (the executor's prefill samples, captures excluded) per thousand uncached prompt tokens, in ms."""
def read(run):
    utok = sum(u for u, _ in run.prefill_samples)
    if utok <= 0:
        return None
    return 1000.0 * sum(d for _, d in run.prefill_samples) / (utok / 1000.0)
