"""Interactive remote viewer (C28-C30 capability parity): the port of
``pathtracer_cuda_interactive_tpu/viewer``."""

from .controls import CameraController  # noqa: F401
from .server import Viewer  # noqa: F401
