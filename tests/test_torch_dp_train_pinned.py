"""The port's data-parallel train step of the completion model at 2 gloo
ranks on the CPU against its one-process step, with each scene's
completed proposals pinned (`pinned_proposal_ids`), so that skip
propagation and the ONet see the same proposals in every layout: every
module's running statistics, the decoder's CBNs included, within 5e-3 /
5e-2 (`tests/test_train.py`'s `test_dp_pinned_selection_bn_stats`), the
loss within 1e-3. The posterior noise is one global draw; each rank takes
its rows (`torch_dist.train_step_rank`). The one-process step runs in
this process while the ranks run in theirs.
"""

import numpy as np

from torch_parity import (DP_BATCH, assert_dp_matches_one_process,
                          grid_batch, port_state, step_variables,
                          train_configs)
import torch_dist


def test_dp_pinned_selection_bn_stats():
    _, cfg = train_configs("stage3_joint")
    limit = cfg["data"]["completion_limit_in_train"]
    batch = grid_batch(5, batch_size=DP_BATCH)
    pin = np.zeros((DP_BATCH, limit, 3), np.int32)
    pin[:, :, 0] = np.arange(limit)
    for b in range(DP_BATCH):
        gt_ids = np.resize(np.flatnonzero(batch["box_label_mask"][b] > 0),
                           limit)
        pin[b, :, 1] = gt_ids
        pin[b, :, 2] = batch["sem_cls_label"][b][gt_ids]
    batch["pinned_proposal_ids"] = pin
    eps = np.random.RandomState(11).randn(
        DP_BATCH * limit, cfg["data"]["z_dim"]).astype(np.float32)
    spec = dict(cfg=cfg, state=port_state(step_variables("completion")),
                batch=batch, eps=eps, lr=float(cfg["optimizer"]["lr"]),
                bn_momentum=0.5)
    ranks = torch_dist.start(torch_dist.train_step_rank, 2, spec)
    one = torch_dist.alone(torch_dist.train_step_rank, spec)
    assert_dp_matches_one_process(ranks.result(), one, "world 2",
                                  stats_atol=5e-3, stats_rtol=5e-2)
