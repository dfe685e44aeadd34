"""SLAM-landmark updater — only the piece the MSCKF-only slice calls.

Counterpart of `slam_row_mask` in `open_vins_tpu/models/updater_slam.py`;
the landmark update, delayed initialization, anchor changes and eviction
come with the port's second slice.
"""

from __future__ import annotations

import torch

from open_vins_tpu_torch.core.state import VioState
from open_vins_tpu_torch.models.feature_table import FeatureTable


def slam_row_mask(state: VioState, table: FeatureTable):
    """[T] bool — table rows whose id is an active SLAM landmark."""
    eq = table.ids[:, None] == state.slam_id[None, :]  # [T, L]
    return torch.any(eq & state.slam_valid[None, :]
                     & (table.ids[:, None] >= 0), dim=1)
