"""The data path: BVH parsing and writing, the skeleton and its forward
kinematics, the pose-representation converter, the windowed dataset
(``pipeline``) and the pymo-style mocap transforms (``mocap_transforms``,
whose rotation math runs in torch on a device).  Numpy in and out."""

from . import mocap_transforms
from .bvh import BvhData, parse_bvh, write_bvh
from .pose_converter import PoseTypeConverter
from .skeleton import Skeleton

__all__ = ["BvhData", "parse_bvh", "write_bvh", "Skeleton", "PoseTypeConverter",
           "mocap_transforms"]
