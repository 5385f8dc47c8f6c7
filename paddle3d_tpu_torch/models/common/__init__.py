from .pointnet2_modules import (PointMLP, SAModuleMSG, Sequential, VoteLayer,
                                group_max, linear)
