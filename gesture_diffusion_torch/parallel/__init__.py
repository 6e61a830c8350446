from .mesh import (Mesh, active_group, init_distributed, is_main_process,
                   make_mesh, replicate, split_batch)

__all__ = ["Mesh", "active_group", "init_distributed", "is_main_process",
           "make_mesh", "replicate", "split_batch"]
