from .bevdet import BEVDet
