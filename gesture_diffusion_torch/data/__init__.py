"""The data path: BVH parsing and writing, the skeleton and its forward
kinematics, the pose-representation converter, and the windowed dataset
(``pipeline``).  Numpy in and out, on the host."""

from .bvh import BvhData, parse_bvh, write_bvh
from .pose_converter import PoseTypeConverter
from .skeleton import Skeleton

__all__ = ["BvhData", "parse_bvh", "write_bvh", "Skeleton", "PoseTypeConverter"]
