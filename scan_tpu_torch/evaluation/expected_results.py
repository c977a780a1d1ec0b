"""TEST.EXPECTED_RESULTS regression checking (counterpart of
``scan_tpu/evaluation/expected_results.py``; reference
``evaluation/coco/coco_eval.py:403-423``, ``check_expected_results``).

A metric passes when it lies within ``sigma_tol`` standard deviations of
its expected mean. As in ``scan_tpu``, nothing calls it: ``test_net`` does
not read ``TEST.EXPECTED_RESULTS``.
"""

import logging

logger = logging.getLogger("scan_tpu_torch.eval")


def check_expected_results(results, expected_results, sigma_tol):
    """expected_results: list of (task, metric, mean, std). results: a
    COCOResults-style dict (task 'bbox' implied). True when every metric
    is present and in range (or nothing is expected)."""
    if not expected_results:
        return True
    ok = True
    for task, metric, mean, std in expected_results:
        actual = results.get(metric)
        if actual is None:
            logger.error("metric %s/%s missing from results", task, metric)
            ok = False
            continue
        lo, hi = mean - sigma_tol * std, mean + sigma_tol * std
        msg = (
            f"{task} > {metric} sanity check (actual vs. expected): "
            f"{actual:.4f} vs. mean={mean:.4f}, std={std:.4f}, "
            f"range=({lo:.4f}, {hi:.4f})"
        )
        if lo <= actual <= hi:
            logger.info("PASSED: %s", msg)
        else:
            logger.error("FAILED: %s", msg)
            ok = False
    return ok
