"""Synthetic Table-1 problems (counterpart of `repro.data`)."""
