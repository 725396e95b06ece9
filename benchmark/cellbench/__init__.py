"""The benchmark harness of hevctpu_torch: cells found by name in
BENCHMARK.json (spec), the traffic generator (traffic, corpus), the
measured window (window), the profiler slice (trace), the check against
the plain reference (check), the yardstick's arithmetic (roofline) and a
run's orchestration (main). It imports neither jax nor the JAX package,
and the program only inside a run."""
