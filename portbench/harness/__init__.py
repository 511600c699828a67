"""The benchmark's yardstick: what it reads from BENCHMARK.json and the
data files under ``portbench/``, the draws, the loops that drive the port,
the reduction of traces to metrics, the work counts and peaks, and the
comparison that decides ``correct``. Nothing here is the program: the
port is reached only through ``harness/port.py``."""
