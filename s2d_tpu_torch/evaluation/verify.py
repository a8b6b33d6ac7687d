"""Expected-results verification, as `s2d_tpu/evaluation/verify.py`:
TEST.EXPECTED_RESULTS lists (task, metric, expected, tolerance) tuples, and
after each dataset's evaluation every listed metric must lie within its
tolerance of the expected value, or the run fails."""
from __future__ import annotations

from typing import Mapping, Sequence


def verify_results(expected: Sequence, results: Mapping[str, float]) -> bool:
    """expected: (task, metric, value, tolerance) entries; `task` is kept for
    config compatibility and the metric is looked up in `results` (one
    dataset's metrics). Raises AssertionError on a miss or a missing metric."""
    if not expected:
        return True
    ok = True
    lines = []
    for task, metric, value, tolerance in expected:
        actual = results.get(metric)
        if actual is None:
            ok = False
            lines.append(f"{task}/{metric}: MISSING (expected {value})")
            continue
        passed = abs(actual - value) <= tolerance
        ok &= passed
        lines.append(f"{task}/{metric}: actual {actual:.4f}, expected {value:.4f} "
                     f"+/- {tolerance:.4f} -> {'OK' if passed else 'FAIL'}")
    report = "\n".join(lines)
    print("Results verification:\n" + report)
    if not ok:
        raise AssertionError("Result verification failed!\n" + report)
    return True
