"""RelServe on PyTorch and CUDA: the port of the JAX package ``repro``.

Same module layout (``repro/X/y.py`` maps to ``repro_torch/X/y.py``); imports
torch and numpy only. Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
