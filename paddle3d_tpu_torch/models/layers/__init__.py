from .layer_libs import ConvBNReLU, DeconvBNReLU, LinearBN1DReLU
