from .base_model import (Base3DModel, BaseLidarModel, BaseMonoModel,
                         BaseMultiViewModel)
