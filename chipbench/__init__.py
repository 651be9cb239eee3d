"""The port's benchmark: `python chipbench/run.py --workload <cell> ...`."""
