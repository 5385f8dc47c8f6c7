from .attentions import (MSDeformableAttention, SpatialCrossAttention,
                         TemporalSelfAttention)
from .bevdet_transformer import LSSViewTransformer
from .transformer_layers import (BaseTransformerLayer, FFN,
                                 MultiHeadAttention, TransformerLayerSequence)
