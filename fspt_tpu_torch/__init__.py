"""fspt_tpu_torch — the PyTorch/CUDA port of the fspt_tpu path tracer.

A second package beside ``fspt_tpu`` with the same module layout.  Plain
tensor code is PyTorch; each Pallas kernel of the reference becomes a CUDA
C++ kernel for Hopper (``csrc/``), built with ``nvcc`` at first use and
bound with ``ctypes``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``, where every kernel's plain PyTorch version runs.
The package never imports ``jax`` or ``fspt_tpu``.
"""

__version__ = "0.1.0"

from fspt_tpu_torch.camera import Camera
from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.scene.builder import SceneBuilder

__all__ = ["Camera", "RenderConfig", "SceneBuilder", "__version__"]
