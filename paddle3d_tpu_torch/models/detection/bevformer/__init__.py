from .bevformer import BEVFormer, BEVFormerEncoderLayer
