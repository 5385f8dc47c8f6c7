from .petr3d import PETR
