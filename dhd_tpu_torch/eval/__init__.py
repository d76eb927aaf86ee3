from .miou import MIoUMetric, confusion_matrix, miou_from_confusion
from .rayiou import (
    calc_rayiou,
    generate_lidar_rays,
    march,
    ray_march,
    rayiou_from_outputs,
    scene_origins,
)

__all__ = [
    "MIoUMetric", "confusion_matrix", "miou_from_confusion",
    "calc_rayiou", "generate_lidar_rays", "march", "ray_march",
    "rayiou_from_outputs", "scene_origins",
]
