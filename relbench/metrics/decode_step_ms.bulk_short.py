"""Executor: the mean of the window's decode batches' seconds (the executor's decode samples), in ms."""
def read(run):
    if not run.decode_samples:
        return None
    return 1000.0 * sum(d for _, d in run.decode_samples) / len(run.decode_samples)
