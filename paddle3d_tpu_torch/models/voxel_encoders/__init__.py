from .pillar_encoder import PillarFeatureNet
from .voxel_encoder import VoxelMean
