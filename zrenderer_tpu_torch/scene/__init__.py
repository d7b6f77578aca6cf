from zrenderer_tpu_torch.scene.mesh import Mesh, MeshData
from zrenderer_tpu_torch.scene.scene import Camera, Mobility, Node, Scene

__all__ = ["Camera", "Mesh", "MeshData", "Mobility", "Node", "Scene"]
