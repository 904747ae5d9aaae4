"""Hand-written CUDA kernels of the port (``csrc/``), their Python wrappers,
their plain PyTorch versions (``ref``) and the device dispatch (``ops``)."""
