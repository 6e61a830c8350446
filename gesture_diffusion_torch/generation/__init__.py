from .generator import Generator, crossfade_head, make_trans_ramp, window_plan

__all__ = ["Generator", "crossfade_head", "make_trans_ramp", "window_plan"]
