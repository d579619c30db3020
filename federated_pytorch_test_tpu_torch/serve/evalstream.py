"""Served traffic as an eval stream — the continuous-learning loop.

Port of ``federated_pytorch_test_tpu/serve/evalstream.py``, numpy only and
copied as it is.

Every serving round scores the answers it just produced against the
requests' labels, maintains an EMA accuracy baseline, and reports a
``drift_score`` (fractional accuracy collapse vs the baseline).  The
recorder forwards each ``serve`` record to ``obs/health.py``'s
``serve_drift`` rule; a sustained collapse raises an alert, and in act
mode the control plane answers with a ``refresh_serving`` intervention
(``control/policy.py``) — train → serve → observe → intervene, closed.

Drift *injection* is the seeded test harness for that loop: from round
``drift_at`` on, the stream's true labels shift by a seeded non-zero
class offset (tag-83 substream), so live accuracy collapses by
construction.  The injection is a pure function of (seed, round_index)
— replay knows exactly which rounds were drifted — while the resulting
accuracy/drift numbers stay advisory.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from federated_pytorch_test_tpu_torch.serve.batcher import SERVE_TAG, ServeSchedule


class EvalStream:
    """Scores served batches and tracks the accuracy baseline."""

    def __init__(self, schedule: ServeSchedule, window: int = 8):
        self.schedule = schedule
        self.window = int(window)
        self._ema: Optional[float] = None
        self._samples = 0

    def drift_labels(self, labels: np.ndarray, round_index: int,
                     n_classes: int) -> np.ndarray:
        """The stream's true labels for this round: unchanged before
        ``drift_at``, shifted by a seeded non-zero class offset after —
        a total label shift, so accuracy collapses by construction."""
        labels = np.asarray(labels)
        if not self.schedule.drift_injected(round_index) or n_classes < 2:
            return labels
        rng = np.random.default_rng(
            [self.schedule.seed, SERVE_TAG, round_index, 1])
        offset = 1 + int(rng.integers(n_classes - 1))
        return (labels + offset) % n_classes

    def score(self, round_index: int, logits: np.ndarray,
              labels: np.ndarray) -> Dict[str, Any]:
        """Score one round of served classifier traffic.

        ``labels`` are the clean ground-truth labels of the requests;
        drift injection (when scheduled) is applied here.  Returns the
        advisory accuracy/drift fields of the round's serve record.
        """
        logits = np.asarray(logits)
        labels = self.drift_labels(labels, round_index,
                                   int(logits.shape[-1]))
        pred = np.argmax(logits, axis=-1)
        acc = float(np.mean(pred == labels)) if pred.size else 0.0
        return self.observe(round_index, acc)

    def observe(self, round_index: int, accuracy: float) -> Dict[str, Any]:
        """Fold one round's accuracy into the EMA baseline and compute
        ``drift_score`` = fractional collapse vs the *previous* baseline
        (0 while the baseline warms over the first ``window`` rounds, so
        a cold start never reads as drift)."""
        base = self._ema
        warmed = self._samples >= self.window
        if warmed and base is not None and base > 0.0:
            drift = max(0.0, round(1.0 - accuracy / base, 6))
        else:
            drift = 0.0
        alpha = 2.0 / (self.window + 1.0)
        self._ema = accuracy if base is None else (
            base + alpha * (accuracy - base))
        self._samples += 1
        return {
            "serve_accuracy": round(accuracy, 6),
            "drift_score": drift,
            "drift_injected": self.schedule.drift_injected(round_index),
        }


def selftest() -> str:
    sched = ServeSchedule.parse("qps=8,drift_at=6,seed=3")
    assert sched is not None
    es = EvalStream(sched, window=4)
    labels = np.arange(10, dtype=np.int64) % 10
    # before drift_at the stream labels are the clean labels
    assert np.array_equal(es.drift_labels(labels, 5, 10), labels)
    # after: a seeded non-zero shift — zero overlap with the clean labels
    drifted = es.drift_labels(labels, 6, 10)
    assert not np.any(drifted == labels)
    assert np.array_equal(drifted, es.drift_labels(labels, 6, 10))
    # perfect predictions: accuracy 1.0 until drift, then collapse
    eye = np.eye(10, dtype=np.float32)
    logits = eye[labels]
    for r in range(6):
        out = es.score(r, logits, labels)
        assert out["serve_accuracy"] == 1.0 and out["drift_score"] == 0.0
        assert out["drift_injected"] is False
    out = es.score(6, logits, labels)
    assert out["drift_injected"] is True
    assert out["serve_accuracy"] == 0.0 and out["drift_score"] == 1.0
    # warmup: no drift signal before `window` samples even on collapse
    cold = EvalStream(sched, window=4)
    assert cold.observe(0, 1.0)["drift_score"] == 0.0
    assert cold.observe(1, 0.0)["drift_score"] == 0.0
    return "serve.evalstream selftest: OK"


if __name__ == "__main__":
    print(selftest())
