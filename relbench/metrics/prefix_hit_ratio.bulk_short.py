"""Prefix cache and block manager: the share of the window's prefix lookups that hit (the PrefixCache's hits and misses over the window), in %."""
from relbench.readers import prefix_hit as read  # noqa: F401
