"""The tile and sample split of a render across devices, over
``torch.distributed`` (sharding.py); the port of
``pathtracer_cuda_interactive_tpu/parallel/``."""

from . import sharding  # noqa: F401
