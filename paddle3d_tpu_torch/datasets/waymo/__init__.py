from .waymo_det import WaymoMetric, WaymoPCDataset
