from deltakd_tpu_torch.parallel.distributed import maybe_initialize_distributed, rank_device
from deltakd_tpu_torch.parallel.mesh import (LOCAL, NO_MODEL, DataParallel, Mesh, ModelParallel,
                                             current, is_main_process, make_mesh, mesh_shape,
                                             param_spec, rank, world)

__all__ = ["LOCAL", "NO_MODEL", "DataParallel", "Mesh", "ModelParallel", "current",
           "is_main_process", "make_mesh", "maybe_initialize_distributed", "mesh_shape",
           "param_spec", "rank", "rank_device", "world"]
