"""Round-2 self-distillation converter, as `tools/convert_results_to_annotations.py`:

    python -m s2d_tpu_torch.tools.convert_results_to_annotations \
        --results OUTPUT/results.json --gt-json datasets/.../instances.json \
        --output round2_annotations.json [--score-threshold 0.75]

Keeps the predictions at or above the score threshold, recomputes bbox and
area from their RLEs, and takes the gt videos' metadata, so the output is a
YTVIS training-annotation file for the next self-distillation round.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--results", required=True)
    parser.add_argument("--gt-json", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--score-threshold", type=float, default=0.75)
    args = parser.parse_args(argv)

    from ..keymask.annotations import convert_results_to_annotations

    with open(args.results) as f:
        results = json.load(f)
    with open(args.gt_json) as f:
        gt = json.load(f)
    out = convert_results_to_annotations(results, gt["videos"],
                                         score_threshold=args.score_threshold)
    with open(args.output, "w") as f:
        json.dump(out, f)
    print(f"wrote {len(out['annotations'])} annotations over {len(out['videos'])} videos "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
