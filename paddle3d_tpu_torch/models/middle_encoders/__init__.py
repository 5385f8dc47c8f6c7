from .pillar_scatter import PointPillarsScatter
from .sparse_resnet import SparseNet3D, SparseResNet3D
