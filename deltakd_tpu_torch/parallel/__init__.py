from deltakd_tpu_torch.parallel.distributed import maybe_initialize_distributed, rank_device
from deltakd_tpu_torch.parallel.mesh import (LOCAL, DataParallel, current, is_main_process,
                                             make_mesh, rank, world)

__all__ = ["LOCAL", "DataParallel", "current", "is_main_process", "make_mesh",
           "maybe_initialize_distributed", "rank", "rank_device", "world"]
