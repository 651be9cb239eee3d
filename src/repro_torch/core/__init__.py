"""The BSP superstep engine (counterpart of `repro.core`)."""
