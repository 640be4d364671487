"""The plain reference: float64 PyTorch in the full site layout, written for
this benchmark.  It imports nothing of the port (tpuqcd_torch), nor JAX,
and is handed only what the benchmark made (the ILDG file's links, the
point sources) and the outputs it judges."""
