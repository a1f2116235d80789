# Port copy of centrifuger_tpu.utils (host code, no accelerator).
"""Shared small utilities: alphabets, encoding tables, memory-string parsing."""

import numpy as np

DNA_ALPHABET = "ACGT"
PROTEIN_ALPHABET = "$ARNDCEQGHILKMFPSTWYV"

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}

# byte-level complement table: non-ACGT -> 'N' (mirrors Classifier::_compChar,
# reference Classifier.hpp:808-814)
COMP_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in _COMP.items():
    COMP_TABLE[ord(_a)] = ord(_b)


def make_encode_table(alphabet):
    """char byte -> code; 255 for chars not in the alphabet."""
    t = np.full(256, 255, dtype=np.uint8)
    for i, c in enumerate(alphabet):
        t[ord(c)] = i
    return t


DNA_ENCODE = make_encode_table(DNA_ALPHABET)
PROTEIN_ENCODE = make_encode_table(PROTEIN_ALPHABET)


def encode_seq(s, table=DNA_ENCODE):
    """Encode an ASCII string/bytes; drops characters not in the alphabet
    (mirrors SequenceCompactor::Compact's default missing handling,
    reference compactds/SequenceCompactor.hpp:72-78)."""
    if isinstance(s, str):
        s = s.encode()
    raw = np.frombuffer(s, dtype=np.uint8)
    codes = table[raw]
    return codes[codes != 255]


def revcomp_bytes(b):
    """Reverse complement of an ASCII read (uint8 array)."""
    return COMP_TABLE[b][::-1]


def log2ceil(x):
    """ceil(log2(x)); mirrors Utils::Log2Ceil (reference compactds/Utils.hpp:154)."""
    if x <= 1:
        return 0
    return int(x - 1).bit_length()


def space_string_to_bytes(s):
    """Parse '240G' style memory strings (reference compactds/Utils.hpp:281-305)."""
    s = s.strip()
    mult = 1
    suffix = s[-1].upper()
    table = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if suffix in table:
        mult = table[suffix]
        s = s[:-1]
    return int(float(s) * mult)


def div_ceil(a, b):
    return (a + b - 1) // b
