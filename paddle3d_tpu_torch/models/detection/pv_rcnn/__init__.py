from .pv_rcnn import PVRCNN, VoxelRCNN
