"""Graphs: the seconds set-up spent capturing CUDA graphs (the executor's capture_s, prestage's included)."""
def read(run):
    return run.capture_setup_s
