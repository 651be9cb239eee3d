"""Hand-written kernels of the port (counterpart of `repro.kernels`)."""
