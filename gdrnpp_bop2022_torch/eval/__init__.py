from .pnp_eval import (depth_refine_batch, pose_from_dense_net_iter, pose_from_dense_ransac,
                       pose_from_dense_uncertainty)
from .pose_error import (add, add_batch, adi, adi_batch, cou_mask, mspd, mspd_batch, mssd,
                         mssd_batch, proj, proj_batch, re, re_batch, te, te_batch)
from .scorer import score_bop_results
from .vsd import depth_to_dist, vsd_batch
