from dhd_tpu_torch.ops.mghs_pool_cuda import (mghs_pool_cuda,
                                              mghs_pool_plan_plain)
from dhd_tpu_torch.ops.voxel_pool import (PoolIndices, PoolPlan,
                                          build_pool_plan,
                                          compute_pool_indices, mghs_pool)

__all__ = ["PoolIndices", "PoolPlan", "build_pool_plan",
           "compute_pool_indices", "mghs_pool", "mghs_pool_cuda",
           "mghs_pool_plan_plain"]
