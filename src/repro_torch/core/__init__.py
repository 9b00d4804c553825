"""HPCC benchmarks of the port (HPL so far)."""
