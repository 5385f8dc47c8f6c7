from .modelnet40 import AccuracyMetric, ModelNet40
