"""End to end: seconds from the process's start to the window's (traffic, weights, engine, captures, warm-up serve)."""
def read(run):
    return run.setup_s
