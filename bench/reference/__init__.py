"""Plain PyTorch reference of a LUT network's forward (``lut``) and its
control in the next narrower code storage (``control``).  Imports
nothing of the port and nothing of JAX."""
