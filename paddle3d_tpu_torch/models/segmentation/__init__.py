from .squeezesegv3 import (SACBlock, SACRangeNet, SqueezeSegV3,
                           SSGLossComputation)
