from .second_backbone import SecondBackbone
