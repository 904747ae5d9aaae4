"""End to end: output tokens of the batches that ran wholly inside the window, over the window's seconds."""
def read(run):
    return run.output_tokens / run.seconds if run.output_tokens else None
