"""Status codes, strategies and the user-facing compression configuration.

The port's copy of `Status`, `Strategy`, `ExecutionPath`, `ChecksumPolicy`,
`CompressionConfig` (with `from_level`), `CompressionStats` and
`estimate_compressed_size` from tpu_zstd/api/config.py: the level table is
the reference's, so a level maps to the same pipeline parameters and the
same frames.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Status(enum.IntEnum):
    """Operation status codes (superset used across the API; mirrors the
    reference's 29-code Status enum semantics, types.h:92-128)."""

    SUCCESS = 0
    ERROR_GENERIC = 1
    ERROR_INVALID_PARAMETER = 2
    ERROR_BUFFER_TOO_SMALL = 3
    ERROR_CORRUPT_DATA = 4
    ERROR_OUT_OF_MEMORY = 5
    ERROR_UNSUPPORTED = 6
    ERROR_NOT_INITIALIZED = 7
    ERROR_DEVICE = 8
    ERROR_CHECKSUM_MISMATCH = 9
    ERROR_DICTIONARY_MISMATCH = 10
    ERROR_DST_SIZE_TOO_SMALL = 11
    ERROR_SRC_EMPTY = 12
    ERROR_FRAME_HEADER = 13
    ERROR_BLOCK_HEADER = 14
    ERROR_LITERALS = 15
    ERROR_SEQUENCES = 16
    ERROR_FSE_TABLE = 17
    ERROR_HUFFMAN_TABLE = 18
    ERROR_OFFSET_TOO_LARGE = 19
    ERROR_CONTENT_SIZE_MISMATCH = 20
    ERROR_WINDOW_TOO_LARGE = 21
    ERROR_DICT_TRAINING = 22
    ERROR_STREAM_STATE = 23
    ERROR_BATCH_PARTIAL = 24
    ERROR_CANCELLED = 25
    ERROR_INTERNAL = 26
    ERROR_IO = 27
    ERROR_TIMEOUT = 28


class Strategy(enum.IntEnum):
    """Parse strategies (reference types.h:162-171)."""

    FAST = 1
    DFAST = 2
    GREEDY = 3
    LAZY = 4
    LAZY2 = 5
    BTLAZY2 = 6
    BTOPT = 7
    BTULTRA = 8


class ExecutionPath(enum.IntEnum):
    """Routing decision of `Manager`: the host codec (CPU) or the card.
    TPU_BATCH and TPU_CHUNK keep the reference's names; in the port both
    mean the CUDA device."""

    AUTO = 0
    CPU = 1
    TPU_BATCH = 2
    TPU_CHUNK = 3


class ChecksumPolicy(enum.IntEnum):
    NONE = 0
    COMPUTE = 1
    COMPUTE_AND_VERIFY = 2


@dataclass
class CompressionConfig:
    """User-facing knobs; `from_level` fills strategy-appropriate defaults."""

    level: int = 3
    strategy: Strategy = Strategy.GREEDY
    window_log: int | None = None
    hash_log: int = 16
    search_depth: int = 2
    compare_cap: int = 32
    min_match: int = 4
    block_size: int = 128 * 1024
    checksum: ChecksumPolicy = ChecksumPolicy.NONE
    enable_ldm: bool = False
    cpu_threshold: int = 1 << 20  # route-to-CPU size threshold (hybrid)
    dict_id: int = 0
    # Emit decoder-checkpoint metadata (a skippable frame stock libzstd
    # ignores) enabling chunk-parallel device decompression (format/accel.py).
    decode_accel: bool = False

    @classmethod
    def from_level(cls, level: int) -> "CompressionConfig":
        """Level -> parameter table (counterpart of types.cpp:147-207)."""
        # Tuned on-chip (mixed corpus, 2026-08-17): sort operand count and
        # chain depth are nearly free on the sorted-domain matcher, so depth
        # and compare cap rise quickly with level; the speed/ratio tradeoffs
        # that matter are Huffman literals (~1.5x slower) and lazy parse.
        level = max(1, min(22, int(level)))
        if level <= 2:
            # Unsampled depth-3 search measured STRICTLY better than the old
            # sample_log=1 acceleration on-chip (2026-08-21: ratio 2.371 ->
            # 2.589 = 90% of libzstd L1, throughput equal) — the cap-12
            # retune shifted the sort-cost balance.
            p = dict(strategy=Strategy.FAST, hash_log=15, search_depth=3, compare_cap=16)
        elif level <= 4:
            # Carried-word count (compare_cap / 4) is a REAL sort cost on v5e:
            # cap 32 -> 12 at depth 12 was +37% throughput for -0.4% ratio,
            # and the round-5 re-sweep found cap 8 BEATS 12 on both axes
            # (parse 46.8 -> 41.5 ms per 128x128K, ratio 2.706 -> 2.713 —
            # the same-offset merge pass re-joins matches truncated at the
            # cap, and shorter carried words improve tie-breaking).
            p = dict(strategy=Strategy.LAZY, hash_log=17, search_depth=8, compare_cap=8)
        elif level <= 6:
            p = dict(strategy=Strategy.LAZY, hash_log=17, search_depth=8, compare_cap=64)
        elif level <= 9:
            p = dict(strategy=Strategy.LAZY2, hash_log=18, search_depth=12, compare_cap=64)
        elif level <= 15:
            p = dict(strategy=Strategy.BTLAZY2, hash_log=18, search_depth=24, compare_cap=64)
        elif level <= 19:
            # Depth sweep on-chip (2026-08-21, L19/2MB): 16 -> 32 -> 48 = 
            # 2.755 -> 2.807 -> 2.824; candidate window 15 -> 16 = +0.9%.
            # min_match 3 like the reference (types.cpp:883-947) at the
            # optimal-parse levels only: the two-pass DP prices a 3-byte
            # match's real bits, so it is taken exactly when it wins.
            p = dict(strategy=Strategy.BTOPT, hash_log=18, search_depth=48,
                     compare_cap=64, min_match=3)
        else:
            p = dict(strategy=Strategy.BTULTRA, hash_log=18, search_depth=96,
                     compare_cap=64, min_match=3)
        # NOTE: enable_ldm (cross-block 64 KB windows via the sampled LDM
        # pass) stays OPT-IN at every level: blocks compress independently by
        # default, exactly like the reference GPU (its multi-GPU/window modes
        # are likewise explicit). Auto-enabling it at ratio levels was
        # measured nearly ratio-neutral on the mixed corpus while multiplying
        # the windowed-path compile surface.
        return cls(level=level, **p)

    def validate(self) -> Status:
        if not (1 <= self.level <= 22):
            return Status.ERROR_INVALID_PARAMETER
        if not (10 <= self.hash_log <= 24):
            return Status.ERROR_INVALID_PARAMETER
        if self.block_size < 1024 or self.block_size > 128 * 1024:
            return Status.ERROR_INVALID_PARAMETER
        if self.compare_cap % 4 != 0 or self.compare_cap < 8:
            return Status.ERROR_INVALID_PARAMETER
        return Status.SUCCESS


@dataclass
class CompressionStats:
    """Cumulative per-manager counters (reference types.h:238-262)."""

    total_input_bytes: int = 0
    total_output_bytes: int = 0
    total_blocks: int = 0
    total_frames: int = 0
    total_compress_calls: int = 0
    total_decompress_calls: int = 0
    total_compress_time_s: float = 0.0
    total_decompress_time_s: float = 0.0

    @property
    def ratio(self) -> float:
        if self.total_output_bytes == 0:
            return 0.0
        return self.total_input_bytes / self.total_output_bytes

    @property
    def compress_throughput_mbps(self) -> float:
        if self.total_compress_time_s == 0:
            return 0.0
        return self.total_input_bytes / self.total_compress_time_s / 1e6

    def reset(self) -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, 0 if isinstance(getattr(self, f), int) else 0.0)


def estimate_compressed_size(input_size: int) -> int:
    """Worst-case frame size: the input, 3 header bytes a 128 KB block (a
    block that does not shrink is stored Raw), the frame header and the
    checksum."""
    nblocks = max(1, -(-input_size // (128 * 1024)))
    return input_size + 3 * nblocks + 18 + 4
