from pyrenderer_tpu_torch.scene.types import Camera, Scene, to_device  # noqa: F401
from pyrenderer_tpu_torch.scene.tungsten import load_tungsten  # noqa: F401
