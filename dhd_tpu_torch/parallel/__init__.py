from dhd_tpu_torch.parallel.mesh import (all_reduce_gradients, barrier,
                                         gather_objects, global_rand,
                                         global_sums, initialize_distributed,
                                         is_distributed,
                                         process_batch_slice,
                                         process_group, rank, shard_batch,
                                         shutdown,
                                         sum_over_processes, world_size)

__all__ = ["all_reduce_gradients", "barrier", "gather_objects",
           "global_rand", "global_sums", "initialize_distributed",
           "is_distributed", "process_batch_slice", "process_group",
           "rank", "shard_batch", "shutdown", "sum_over_processes",
           "world_size"]
