"""Candidate keymask export, the port of `s2d_tpu/keymask/export.py`: the
winner masks of every (cluster, visibility range) written as binary PNGs
`cluster{c}_frame{f}_mask{m}.png` (0 and 255, through `data/png.py`), for
inspection of the discovery state.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from ..data.png import write_png


def winner_mask(masks_per_frame: Sequence[Dict[int, np.ndarray]], frame: int, mask_id: int):
    """The seed mask of a visibility record: its key in the frame's masks,
    else (defensively) its 1-based ordinal there, else None."""
    frame_masks = masks_per_frame[frame]
    mask = frame_masks.get(mask_id)
    if mask is None:
        ordered = list(frame_masks.values())
        if 0 <= mask_id - 1 < len(ordered):
            mask = ordered[mask_id - 1]
    return mask


def save_candidate_masks(
    out_dir: str,
    windows: List[dict],  # from keymask.windows.visibility_windows
    records: List[dict],  # from keymask.visibility.extract_visibility_curves
    masks_per_frame: Sequence[Dict[int, np.ndarray]],
) -> List[str]:
    """Writes the winner candidate masks; returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for wrec in windows:
        for row in wrec["winners"]:
            rec = records[row]
            mask = winner_mask(masks_per_frame, rec["frame"], rec["mask_id"])
            if mask is None:
                continue
            path = os.path.join(
                out_dir, f"cluster{wrec['cluster']}_frame{rec['frame']}_mask{rec['mask_id']}.png")
            write_png(path, mask.astype(np.uint8) * 255)
            written.append(path)
    return written
