from .custom_resnet import CustomResNet
from .dla import DLA, DLA34, DLABase34
from .hrnet import HRNet, HRNet_W18
from .resnet import ResNet
from .second_backbone import BaseBEVBackbone, SecondBackbone
from .vovnet import VoVNet, VoVNetCP
