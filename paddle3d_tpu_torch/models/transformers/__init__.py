from .attentions import (MSDeformableAttention, SpatialCrossAttention,
                         TemporalSelfAttention)
from .bevdet_transformer import (DepthNet, LSSViewTransformer,
                                 LSSViewTransformerBEVDepth, MSDepthNet,
                                 MSLSSViewTransformerBEVDepth)
from .positional_encoding import (LearnedPositionalEncoding,
                                  LearnedPositionalEncoding3D,
                                  SinePositionalEncoding,
                                  SinePositionalEncoding3D)
from .transformer_layers import (BaseTransformerLayer, FFN,
                                 MultiHeadAttention, TransformerLayerSequence)
