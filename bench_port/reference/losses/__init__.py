from bench_port.reference.losses.height_loss import (bce_distribution_loss,
                                              depth_height_labels,
                                              downsample_min_nonzero,
                                              shifted_onehot_labels)
from bench_port.reference.losses.occ_loss import (geo_scal_loss, occ_ce_loss,
                                           occ_losses_fused,
                                           occ_losses_fused_packed,
                                           sem_scal_loss)

__all__ = ["bce_distribution_loss", "depth_height_labels",
           "downsample_min_nonzero", "geo_scal_loss", "occ_ce_loss",
           "occ_losses_fused", "occ_losses_fused_packed", "sem_scal_loss",
           "shifted_onehot_labels"]
