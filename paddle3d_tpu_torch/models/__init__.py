from . import backbones, common, detection, heads, losses, \
    middle_encoders, necks, optimizers, point_encoders, transformers, \
    voxel_encoders, voxelizers
