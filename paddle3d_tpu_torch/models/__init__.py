from . import backbones, common, detection, heads, losses, \
    middle_encoders, necks, optimizers, point_encoders, voxel_encoders, \
    voxelizers
