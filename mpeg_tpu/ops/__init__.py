"""Compute kernels: the device-side (JAX/XLA) half of the framework.

Host parsers (serial bit work) emit dense arrays; these ops consume them in
whole-frame batched dispatches.  Every op also runs under numpy for the
scalar-oracle parity tests.
"""
