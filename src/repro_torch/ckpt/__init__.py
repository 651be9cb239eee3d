"""repro_torch.ckpt — frontier checkpoints (counterpart of `repro.ckpt`).

  checkpoint.py  the generic step format: crash-safe publish, per-leaf
                 crc32s, newest-valid fallback; numpy and torch only.
  mining.py      the BSP carry (`core.engine.CARRY_FIELDS`) as a step, with
                 provenance and elastic resharding onto another miner count.

Both packages write and read the same steps (DESIGN.md §11).
"""
