from . import backbones, classification, common, detection, heads, \
    losses, middle_encoders, necks, optimizers, point_encoders, \
    segmentation, transformers, voxel_encoders, voxelizers
