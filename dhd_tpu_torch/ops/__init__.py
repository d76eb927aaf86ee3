from dhd_tpu_torch.ops.cost_volume import (build_cv_plan, build_cv_static,
                                           cv_plan_from_static,
                                           stereo_cost_volume,
                                           stereo_reproject_grid)
from dhd_tpu_torch.ops.cost_volume_cuda import (cv_cost_plain,
                                                stereo_cost_volume_cuda)
from dhd_tpu_torch.ops.dvr import render, render_expected_depth, render_rays
from dhd_tpu_torch.ops.layer_norm import (fused_layer_norm_cuda,
                                          layer_norm_plain)
from dhd_tpu_torch.ops.mghs_pool_cuda import (mghs_pool_cuda,
                                              mghs_pool_plan_plain)
from dhd_tpu_torch.ops.segment_sum import (segment_sum_pooling,
                                           sorted_segment_sum,
                                           sorted_segment_sum_plain)
from dhd_tpu_torch.ops.voxel_pool import (PoolIndices, PoolPlan, bev_pool,
                                          bev_pool_v2, build_pool_plan,
                                          compute_pool_indices, mghs_pool)
from dhd_tpu_torch.ops.warp import grid_sample_2d
from dhd_tpu_torch.ops.window_attention import (window_attention_cuda,
                                                window_attention_plain)

__all__ = ["PoolIndices", "PoolPlan", "bev_pool", "bev_pool_v2",
           "build_cv_plan", "build_cv_static", "build_pool_plan",
           "compute_pool_indices", "cv_cost_plain", "cv_plan_from_static",
           "fused_layer_norm_cuda", "grid_sample_2d", "layer_norm_plain",
           "mghs_pool", "mghs_pool_cuda", "mghs_pool_plan_plain", "render",
           "render_expected_depth", "render_rays",
           "segment_sum_pooling", "sorted_segment_sum",
           "sorted_segment_sum_plain", "stereo_cost_volume",
           "stereo_cost_volume_cuda", "stereo_reproject_grid",
           "window_attention_cuda", "window_attention_plain"]
