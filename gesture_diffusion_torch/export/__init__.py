"""Export of generated samples: BVH files (``pose2bvh``), skeleton videos
with the speech muxed in (``vis_skeleton``, ``avi``, ``mp4``) and
foot-contact features (``features``), and a self-contained HTML player of
a position-parameterised track (``mocap_player``).  Host work, numpy in and
out."""

from .avi import read_avi_structure, write_avi
from .mocap_player import nb_play_mocap, render_mocap_player_html
from .mp4 import read_mp4_structure, write_mp4
from .pose2bvh import (
    pose2bvh,
    pose2bvh_consistent,
    sample2bvh_batch,
    butter_lowpass_filter,
)

__all__ = ["pose2bvh", "pose2bvh_consistent", "sample2bvh_batch",
           "butter_lowpass_filter", "write_avi", "read_avi_structure",
           "write_mp4", "read_mp4_structure",
           "nb_play_mocap", "render_mocap_player_html"]
