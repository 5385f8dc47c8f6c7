from .rtebev import RTEBev
