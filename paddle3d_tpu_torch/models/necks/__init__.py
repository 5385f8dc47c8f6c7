from .second_fpn import SecondFPN
from .fpn import CPFPN, FPN, FPNC, LastLevelP6, LastLevelP6P7
from .lss_fpn import FPN_LSS
