"""Pixel gradients of the plain integrator (inverse.py); the port of
``pathtracer_cuda_interactive_tpu/grad/``."""

from . import inverse  # noqa: F401
