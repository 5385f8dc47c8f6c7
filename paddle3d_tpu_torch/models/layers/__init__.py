from .layer_libs import ConvBNReLU, DeconvBNReLU, LinearBN1DReLU
from .sparse_layers import (MaskedBatchNorm, SparseBasicBlock, SparseConv3D,
                            SparseTensor)
