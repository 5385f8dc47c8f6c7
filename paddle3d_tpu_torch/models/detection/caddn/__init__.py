from .caddn import CADDN
