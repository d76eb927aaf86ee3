from dhd_tpu_torch.models.dhd import (DHDNet, MGHSTransform,
                                      band_masks_from_height,
                                      build_batch_pool_plan, collapse_z,
                                      init_weights)

__all__ = ["DHDNet", "MGHSTransform", "band_masks_from_height",
           "build_batch_pool_plan", "collapse_z", "init_weights"]
