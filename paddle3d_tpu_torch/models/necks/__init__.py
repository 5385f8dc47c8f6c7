from .second_fpn import SecondFPN
