"""RFC 8878 (Zstandard) format constants and code tables.

The port's own copy of the tables it needs (magics, block, literal and
sequence-mode types, LL/ML code tables and extra bits, predefined FSE
distributions, FSE and Huffman limits, the LL/ML/OF code functions of the
host encoder); values follow RFC 8878 and are held equal to
tpu_zstd/constants.py by the tests.
"""

from __future__ import annotations

import numpy as np

# --- Frame-level magic numbers -------------------------------------------------
ZSTD_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC_MIN = 0x184D2A50
SKIPPABLE_MAGIC_MAX = 0x184D2A5F
DICT_MAGIC = 0xEC30A437

BLOCK_SIZE_MAX = 128 * 1024  # RFC 8878 Block_Maximum_Size upper bound

# Block types (2-bit field in block header)
BLOCK_RAW = 0
BLOCK_RLE = 1
BLOCK_COMPRESSED = 2

# Literals block types (2-bit field in the literals section header)
LIT_RAW = 0
LIT_RLE = 1
LIT_COMPRESSED = 2  # Huffman with its table
LIT_TREELESS = 3    # Huffman reusing the previous table

# Sequence-section compression modes (2-bit fields of the modes byte)
SEQ_PREDEFINED = 0
SEQ_RLE = 1
SEQ_FSE = 2
SEQ_REPEAT = 3

REPCODE_INIT = (1, 4, 8)  # RFC 8878 §3.1.1.5: initial repeat offsets

# --- Literals-length codes (RFC 8878 table: code -> (baseline, nb extra bits)) --
_LL_EXTRA = [(code, 0) for code in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1),
    (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8),
    (512, 9), (1024, 10), (2048, 11), (4096, 12),
    (8192, 13), (16384, 14), (32768, 15), (65536, 16),
]
LL_BASELINE = np.array([b for b, _ in _LL_EXTRA], dtype=np.uint32)
LL_BITS = np.array([n for _, n in _LL_EXTRA], dtype=np.uint32)

# --- Match-length codes (code -> (baseline, nb extra bits)) ---------------------
_ML_EXTRA = [(code + 3, 0) for code in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1),
    (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7),
    (259, 8), (515, 9), (1027, 10), (2051, 11),
    (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16),
]
ML_BASELINE = np.array([b for b, _ in _ML_EXTRA], dtype=np.uint32)
ML_BITS = np.array([n for _, n in _ML_EXTRA], dtype=np.uint32)

# Direct lookup tables for value -> code (vectorizable; mirrors the RFC mapping).
# Literal lengths 0..63 map through LL_CODE_TABLE; >=64 use 19 + highbit(ll).
LL_CODE_TABLE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 16, 17, 17, 18, 18, 19, 19,
     20, 20, 20, 20, 21, 21, 21, 21,
     22, 22, 22, 22, 22, 22, 22, 22,
     23, 23, 23, 23, 23, 23, 23, 23,
     24, 24, 24, 24, 24, 24, 24, 24,
     24, 24, 24, 24, 24, 24, 24, 24],
    dtype=np.uint32,
)
LL_DELTA_CODE = 19

# Match lengths: index by (ml - 3) for ml-3 in 0..127; >=128 use 36 + highbit(ml-3).
ML_CODE_TABLE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
     32, 32, 33, 33, 34, 34, 35, 35,
     36, 36, 36, 36, 37, 37, 37, 37,
     38, 38, 38, 38, 38, 38, 38, 38,
     39, 39, 39, 39, 39, 39, 39, 39,
     40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40,
     41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41,
     42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42,
     42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42],
    dtype=np.uint32,
)
ML_DELTA_CODE = 36

# --- Predefined FSE distributions (RFC 8878 §3.1.1.3.2.2) -----------------------
LL_DEFAULT_NORM = np.array(
    [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
     2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
     -1, -1, -1, -1],
    dtype=np.int32,
)
LL_DEFAULT_LOG = 6

ML_DEFAULT_NORM = np.array(
    [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
     -1, -1, -1, -1, -1],
    dtype=np.int32,
)
ML_DEFAULT_LOG = 6

OF_DEFAULT_NORM = np.array(
    [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1],
    dtype=np.int32,
)
OF_DEFAULT_LOG = 5

# FSE and Huffman limits
FSE_MAX_TABLELOG = 12
FSE_MIN_TABLELOG = 5
FSE_DEFAULT_TABLELOG = 11
HUF_MAX_BITS = 11  # literal code-length limit (decode tables of 2^11 entries)
HUF_WEIGHT_FSE_LOG_MAX = 6


def highbit32(v):
    """Position of the highest set bit (floor(log2(v))) of v >= 1: a Python
    int for a Python or numpy integer, an int32 array for an array."""
    if isinstance(v, (int, np.integer)):
        return int(v).bit_length() - 1
    v = np.asarray(v, dtype=np.uint32)
    out = np.zeros(v.shape, dtype=np.int32)
    for shift in (16, 8, 4, 2, 1):
        mask = v >= (np.uint32(1) << np.uint32(shift))
        out += np.where(mask, shift, 0).astype(np.int32)
        v = np.where(mask, v >> np.uint32(shift), v)
    return out


def ll_code(ll):
    """Literal length value -> LL code (scalar or numpy array)."""
    ll = np.asarray(ll, dtype=np.uint32)
    small = ll < 64
    return np.where(
        small, LL_CODE_TABLE[np.minimum(ll, 63)], LL_DELTA_CODE + highbit32(np.maximum(ll, 1))
    ).astype(np.uint32)


def ml_code(ml):
    """Match length value (>= 3) -> ML code."""
    ml = np.asarray(ml, dtype=np.uint32)
    base = ml - 3
    small = base < 128
    return np.where(
        small, ML_CODE_TABLE[np.minimum(base, 127)], ML_DELTA_CODE + highbit32(np.maximum(base, 1))
    ).astype(np.uint32)


def of_code(off_base):
    """Offset base value (offset + 3, or repcode 1..3) -> OF code (its high bit)."""
    return highbit32(off_base)
