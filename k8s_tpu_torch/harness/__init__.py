"""Serving benches of the port: ``bench_serve`` (single-flight against
the continuous-batching engine, the sampled and speculative lanes),
``bench_kvtier`` (the host spill tier, spill identity, dedup migration)
and ``bench_serve_mp`` (a 1-process against an N-process serving gang).
Each is the twin of the module of the same name in the reference's
``harness/``, over the port's server, engine and gang, and prints one
JSON line."""
