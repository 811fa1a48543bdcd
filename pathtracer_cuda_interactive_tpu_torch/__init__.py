"""pathtracer_cuda_interactive_tpu_torch — the PyTorch and CUDA port of the
progressive path tracer in ``pathtracer_cuda_interactive_tpu``.

Same subpackage layout and module names as the JAX package, which stays the
reference it is tested against: ``io/`` and ``models/`` build scenes on the
host in numpy, ``ops/`` holds the device code in torch and the wrappers of
the hand-written CUDA kernels in ``csrc/`` (``megakernel.cu`` for small
scenes, ``brick_trace.cu`` for the sorted wavefront of large ones),
``render/`` the progressive renderer and the offline CLI.  This package
imports torch and numpy, never jax.  ``scenes/`` holds in-repo scenes and
the generator of the large-scene test mesh.
"""

from pathlib import Path

__version__ = "0.1.0"

SCENES_DIR = Path(__file__).resolve().parent / "scenes"

from .models.scenepack import ScenePack, load_scene, pack_scene  # noqa: E402,F401
from .io.xml_scene import parse_scene  # noqa: E402,F401
