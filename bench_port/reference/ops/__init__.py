from bench_port.reference.ops.attention import window_attention_plain
from bench_port.reference.ops.cost_volume import (build_cv_plan,
                                                  cv_cost_plain,
                                                  stereo_cost_volume)
from bench_port.reference.ops.layer_norm import layer_norm_plain
from bench_port.reference.ops.voxel_pool import (PoolIndices,
                                                 compute_pool_indices,
                                                 mghs_pool)
from bench_port.reference.ops.warp import grid_sample_2d

__all__ = ["PoolIndices", "build_cv_plan", "compute_pool_indices",
           "cv_cost_plain", "grid_sample_2d", "layer_norm_plain",
           "mghs_pool", "stereo_cost_volume", "window_attention_plain"]
