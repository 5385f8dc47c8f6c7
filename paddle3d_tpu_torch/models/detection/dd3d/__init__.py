from .dd3d import DD3D
