from ttscube_tpu_torch.parallel.mesh import (make_mesh, make_parallel_synthesis,
                                             make_parallel_train_step, partition_params,
                                             shard_batch)

__all__ = ["make_mesh", "partition_params", "shard_batch", "make_parallel_train_step",
           "make_parallel_synthesis"]
