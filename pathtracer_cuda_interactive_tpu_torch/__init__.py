"""pathtracer_cuda_interactive_tpu_torch — the PyTorch and CUDA port of the
progressive path tracer in ``pathtracer_cuda_interactive_tpu``.

Same subpackage layout and module names as the JAX package, which stays the
reference it is tested against: ``io/`` and ``models/`` build scenes on the
host in numpy, ``ops/`` holds the device code in torch plus the hand-written
CUDA megakernel (``csrc/megakernel.cu``), ``render/`` the progressive
renderer and the offline CLI.  This package imports torch and numpy, never
jax.  ``scenes/`` holds small in-repo scenes.
"""

from pathlib import Path

__version__ = "0.1.0"

SCENES_DIR = Path(__file__).resolve().parent / "scenes"

from .models.scenepack import ScenePack, load_scene, pack_scene  # noqa: E402,F401
from .io.xml_scene import parse_scene  # noqa: E402,F401
