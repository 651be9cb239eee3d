"""The harness of `chipbench/run.py`: cells, data, drivers, traces, checks."""
