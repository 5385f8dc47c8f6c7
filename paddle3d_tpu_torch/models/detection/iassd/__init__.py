from .iassd import IASSD
