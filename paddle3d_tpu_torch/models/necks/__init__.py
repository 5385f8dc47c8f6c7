from .second_fpn import SecondFPN
from .fpn import CPFPN, FPN
