"""Merge per-video keymask JSONs into one dataset, as `tools/merge_ytvis_jsons.py`:

    python -m s2d_tpu_torch.tools.merge_ytvis_jsons --input-dir annotations/ \
        --output dataset.json [--one2x-threshold 2]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input-dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--one2x-threshold", type=int, default=None,
                        help="drop tracks whose one2x noise count exceeds this")
    args = parser.parse_args(argv)

    from ..keymask.annotations import merge_video_jsons

    paths = sorted(glob.glob(os.path.join(args.input_dir, "*.json")))
    if not paths:
        raise SystemExit(f"no JSONs under {args.input_dir!r}")
    merged = merge_video_jsons(paths, one2x_threshold=args.one2x_threshold)
    with open(args.output, "w") as f:
        json.dump(merged, f)
    print(f"merged {len(paths)} videos: {len(merged['videos'])} videos, "
          f"{len(merged['annotations'])} annotations -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
