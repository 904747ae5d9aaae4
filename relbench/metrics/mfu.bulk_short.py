"""Model step: model operations of the window's batches (flops.py, real lengths) over 989e12 FLOP/s times the sum of their walls, in %."""
from relbench.readers import step_mfu as read  # noqa: F401
