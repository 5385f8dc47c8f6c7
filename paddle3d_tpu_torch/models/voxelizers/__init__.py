from .voxelize import HardVoxelizer
