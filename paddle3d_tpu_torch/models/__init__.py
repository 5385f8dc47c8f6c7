from . import backbones, detection, losses, middle_encoders, necks, \
    optimizers, voxel_encoders, voxelizers
