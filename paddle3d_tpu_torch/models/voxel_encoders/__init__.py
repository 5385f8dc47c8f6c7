from .pillar_encoder import PillarFeatureNet
