"""The paper-figure harness on the port (counterpart of the root's ``benchmarks/``).

One module per paper table or figure, each a ``bench(fast=False,
device=None)`` returning ``(name, us_per_call, derived)`` rows under the
reference's row names; `repro_torch.benchmarks.run` prints them as CSV.
The root's ``benchmarks/`` stays the JAX package's harness.
"""
