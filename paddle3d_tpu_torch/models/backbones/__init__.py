from .dla import DLA, DLA34
from .second_backbone import SecondBackbone
