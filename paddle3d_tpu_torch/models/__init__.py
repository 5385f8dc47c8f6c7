from . import backbones, detection, middle_encoders, necks, voxel_encoders, \
    voxelizers
