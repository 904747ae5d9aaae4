"""Scheduler: the engine's scheduling seconds (DPU, ABA, admission; EngineCore.schedule_time) over the window's batches, in ms a batch."""
def read(run):
    n = len(run.window_batches())
    return 1000.0 * run.schedule_s / n if n else None
