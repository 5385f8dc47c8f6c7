from .pillar_scatter import PointPillarsScatter
