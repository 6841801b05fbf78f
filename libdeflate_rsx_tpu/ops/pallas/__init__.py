"""Pallas kernels for the GPU (Triton route).

inflate_tokens — pass 1 of the batch decoder: lockstep entropy decode
of many DEFLATE streams, one token per stream per step.
"""
