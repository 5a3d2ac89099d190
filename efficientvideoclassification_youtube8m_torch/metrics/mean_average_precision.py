"""Per-class (macro) mean-average-precision accumulator.

Capability-parity with
`mean_average_precision_calculator.py`:
one `AveragePrecisionCalculator` per class. (The reference's dead-path
bug when `num_positives` is omitted — iterating an int — is fixed here;
that path is never hit by the reference's own callers.)
"""

from __future__ import annotations

from typing import List, Optional

from efficientvideoclassification_youtube8m_torch.metrics.average_precision import (
    AveragePrecisionCalculator,
)


class MeanAveragePrecisionCalculator:
    def __init__(self, num_class: int):
        if not isinstance(num_class, int) or num_class <= 1:
            raise ValueError("num_class must be a positive integer.")
        self._num_class = num_class
        self._ap_calculators = [
            AveragePrecisionCalculator() for _ in range(num_class)
        ]

    def accumulate(self, predictions, actuals, num_positives: Optional[list] = None):
        """predictions/actuals: per-class lists of score/label lists."""
        # the reference's explicit validation (mean_average_precision_
        # calculator.py:70-76): a bare truthiness test would raise
        # "truth value of an array is ambiguous" for numpy input and an
        # IndexError (not a clear message) for a short list
        if num_positives is not None:
            if not isinstance(num_positives, list):
                num_positives = list(num_positives)
            if len(num_positives) != self._num_class:
                raise ValueError(
                    "num_positives must have the same length as the "
                    f"number of classes ({self._num_class}); got "
                    f"{len(num_positives)}")
        else:
            num_positives = [None] * self._num_class
        for i in range(len(predictions)):
            self._ap_calculators[i].accumulate(
                predictions[i], actuals[i], num_positives[i]
            )

    def clear(self):
        for calculator in self._ap_calculators:
            calculator.clear()

    def is_empty(self) -> bool:
        return all(c.heap_size == 0 for c in self._ap_calculators)

    def peek_map_at_n(self) -> List[float]:
        from efficientvideoclassification_youtube8m_torch.metrics.average_precision import (
            _native,
            _native_perm_ok,
        )

        calcs = self._ap_calculators
        native = _native()
        if (native is not None and _native_perm_ok(native)
                and all(c._top_n is None for c in calcs)):
            # batch all 4716 per-class sweeps into ONE C call (shuffle +
            # stable sort + sweep per segment, bit-identical to
            # peek_ap_at_n) — per-class Python/ctypes overhead dominates
            # the epoch finalize otherwise
            import numpy as np

            sizes = np.fromiter((c._n for c in calcs), np.int64, len(calcs))
            ends = np.cumsum(sizes)
            starts = ends - sizes
            preds = np.concatenate(
                [c._pred_heap[: c._n] for c in calcs]
            ) if ends[-1] else np.zeros(0, np.float64)
            acts = np.concatenate(
                [c._act_heap[: c._n] for c in calcs]
            ) if ends[-1] else np.zeros(0, np.float64)
            num_pos = np.fromiter(
                (float(c._total_positives) for c in calcs), np.float64,
                len(calcs),
            )
            return [float(x) for x in
                    native.ap_sweep(preds, acts, starts, ends, num_pos, -1)]
        return [c.peek_ap_at_n() for c in calcs]
