from .transformer_layers import (BaseTransformerLayer, FFN,
                                 MultiHeadAttention, TransformerLayerSequence)
