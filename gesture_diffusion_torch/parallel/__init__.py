from .mesh import (Mesh, active_group, data_group, init_distributed,
                   is_main_process, make_mesh, model_axis, model_group,
                   replicate, split_batch)
from .tp import (apply_tensor_parallel, full_state_dict, gather_full,
                 tensor_parallel_plan)

__all__ = ["Mesh", "active_group", "apply_tensor_parallel", "data_group",
           "full_state_dict", "gather_full", "init_distributed", "is_main_process",
           "make_mesh", "model_axis", "model_group", "replicate",
           "split_batch", "tensor_parallel_plan"]
