"""The port's benchmark: python cardbench/run.py --workload <cell> ... (README.md)."""
