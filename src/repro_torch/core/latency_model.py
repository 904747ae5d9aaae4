"""Linear batch-duration predictors (paper §4.2, Eq. 9 / Fig. 7).

``L_prefill(p) = α_p · utok(p) + β_p`` — only *uncached* tokens cost compute
(the paper's Fig. 7 shows this is what restores linearity under prefix caching).
``L_decode(d) = α_d · req(d) + β_d``.

Constants are fit offline: ``fit()`` least-squares over profiled (x, duration)
samples. ``a100_opt13b()`` ships constants matching the paper's OPT-13B/A100
regime (used by the simulated-clock executor); ``calibrate_on_host()`` fits
against the real JAX executor on this machine.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class BatchLatencyModel:
    alpha_p: float   # s per uncached prefill token
    beta_p: float    # s per prefill batch
    alpha_d: float   # s per request in the decode batch
    beta_d: float    # s per decode batch

    def prefill_time(self, uncached_tokens: int) -> float:
        return self.alpha_p * uncached_tokens + self.beta_p

    def decode_time(self, num_requests: int) -> float:
        return self.alpha_d * num_requests + self.beta_d

    def mixed_time(self, uncached_tokens: int, num_decode_requests: int) -> float:
        """Sarathi-style chunked-prefill batch: one pass over both."""
        return (self.alpha_p * uncached_tokens + self.alpha_d * num_decode_requests
                + max(self.beta_p, self.beta_d))

    def scaled(self, factor: float) -> "BatchLatencyModel":
        return BatchLatencyModel(self.alpha_p * factor, self.beta_p * factor,
                                 self.alpha_d * factor, self.beta_d * factor)


def a100_opt13b() -> BatchLatencyModel:
    """Paper regime (Fig. 7: prefill ~0.1-0.4s up to ~2k tokens; decode
    ~0.03-0.1s up to ~256 requests)."""
    return BatchLatencyModel(alpha_p=0.8e-4, beta_p=0.03, alpha_d=1.0e-4, beta_d=0.025)


def fit(prefill_samples: Sequence[Tuple[int, float]],
        decode_samples: Sequence[Tuple[int, float]]) -> BatchLatencyModel:
    """Least-squares fit of (x, seconds) samples for each phase."""
    def linfit(samples):
        xs = np.asarray([s[0] for s in samples], np.float64)
        ys = np.asarray([s[1] for s in samples], np.float64)
        if len(xs) < 2 or np.allclose(xs, xs[0]):
            return 0.0, float(ys.mean()) if len(ys) else 0.0
        A = np.stack([xs, np.ones_like(xs)], axis=1)
        (a, b), *_ = np.linalg.lstsq(A, ys, rcond=None)
        return float(max(a, 0.0)), float(max(b, 0.0))

    ap, bp = linfit(prefill_samples)
    ad, bd = linfit(decode_samples)
    return BatchLatencyModel(ap, bp, ad, bd)


def r_squared(samples: Sequence[Tuple[int, float]], a: float, b: float) -> float:
    xs = np.asarray([s[0] for s in samples], np.float64)
    ys = np.asarray([s[1] for s in samples], np.float64)
    pred = a * xs + b
    ss_res = float(np.sum((ys - pred) ** 2))
    ss_tot = float(np.sum((ys - ys.mean()) ** 2))
    return 1.0 - ss_res / max(ss_tot, 1e-12)
