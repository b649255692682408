"""Measuring tools of the port: probes and benchmarks built on the kernel
layer (``ops/``) and the search, kept out of both."""
