"""Adaptive compression-level selection from data characteristics.

The port's copy of tpu_zstd/api/adaptive.py (numpy only, on the host): the
first 64 KB of the input are sampled for byte entropy, the repetition of
4-byte windows at strides 4-32 and the density of distinct 4-byte
windows, and {compressibility} x preference maps to a level of 1-22.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from .config import CompressionConfig

SAMPLE_SIZE = 64 * 1024


class Preference(enum.IntEnum):
    SPEED = 0
    BALANCED = 1
    RATIO = 2


@dataclass
class DataProfile:
    entropy_bits: float       # 0..8 byte entropy of the sample
    repetition: float         # fraction of positions repeating a 4-byte window
    pattern_density: float    # distinct 4-mers / positions (low => patterned)
    compressible: bool

    @property
    def compressibility(self) -> float:
        """0 (incompressible) .. 1 (highly compressible)."""
        h = 1.0 - self.entropy_bits / 8.0
        return max(0.0, min(1.0, 0.5 * h + 0.35 * self.repetition
                            + 0.15 * (1 - self.pattern_density)))


def analyze(data: bytes) -> DataProfile:
    sample = np.frombuffer(data[:SAMPLE_SIZE], dtype=np.uint8)
    n = len(sample)
    if n == 0:
        return DataProfile(8.0, 0.0, 1.0, False)
    counts = np.bincount(sample, minlength=256).astype(np.float64)
    p = counts[counts > 0] / n
    entropy = float(-(p * np.log2(p)).sum())
    if n >= 8:
        w = (
            sample[:-3].astype(np.uint32)
            | (sample[1:-2].astype(np.uint32) << 8)
            | (sample[2:-1].astype(np.uint32) << 16)
            | (sample[3:].astype(np.uint32) << 24)
        )
        rep4 = 0.0
        for stride in (4, 8, 16, 32):
            if len(w) > stride:
                rep4 = max(rep4, float(np.mean(w[stride:] == w[:-stride])))
        uniq = len(np.unique(w))
        pattern_density = uniq / len(w)
    else:
        rep4, pattern_density = 0.0, 1.0
    compressible = entropy < 7.5 or rep4 > 0.05
    return DataProfile(entropy, rep4, pattern_density, compressible)


def select_adaptive_level(data: bytes, preference: Preference = Preference.BALANCED) -> int:
    """Decision table mapping the profile to a level (adaptive.cu:243-280)."""
    prof = analyze(data)
    c = prof.compressibility
    if not prof.compressible:
        base = 1
    elif c > 0.75:
        base = {Preference.SPEED: 1, Preference.BALANCED: 3, Preference.RATIO: 9}[preference]
    elif c > 0.45:
        base = {Preference.SPEED: 2, Preference.BALANCED: 5, Preference.RATIO: 15}[preference]
    elif c > 0.2:
        base = {Preference.SPEED: 3, Preference.BALANCED: 7, Preference.RATIO: 19}[preference]
    else:
        base = {Preference.SPEED: 1, Preference.BALANCED: 3, Preference.RATIO: 12}[preference]
    return max(1, min(22, base))


def is_compressible(data: bytes) -> bool:
    return analyze(data).compressible


class AdaptiveLevelSelector:
    """Stateful selector with preference + config synthesis."""

    def __init__(self, preference: Preference = Preference.BALANCED):
        self.preference = preference
        self.last_profile: DataProfile | None = None

    def select(self, data: bytes) -> int:
        self.last_profile = analyze(data)
        return select_adaptive_level(data, self.preference)

    def config_for(self, data: bytes) -> CompressionConfig:
        return CompressionConfig.from_level(self.select(data))
