from .second_fpn import SecondFPN
from .fpn import CPFPN, FPN
from .lss_fpn import FPN_LSS
