from .generator import (Generator, GestureStream, crossfade_head,
                        make_trans_ramp, window_plan)

__all__ = ["Generator", "GestureStream", "crossfade_head", "make_trans_ramp",
           "window_plan"]
