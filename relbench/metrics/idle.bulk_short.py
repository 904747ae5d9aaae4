"""Device: the share of the traced sub-window in which no kernel, copy or set ran on the card, in %."""
from relbench.readers import idle as read  # noqa: F401
