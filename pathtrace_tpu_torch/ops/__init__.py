"""Tracing ops: intersection, sampling, the wavefront and the kernel."""
