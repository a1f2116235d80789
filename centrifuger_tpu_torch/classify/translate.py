# Port copy of centrifuger_tpu.classify.translate (host code, no accelerator).
"""DNA -> amino acid translation for protein-database (translated) search.

Codon table matches Classifier::DnaToAa (reference Classifier.hpp:123-232):
a codon containing 'N' -> '?'; stop codons -> '_'; the caller replaces both
with 'A' (Classifier.hpp:462-464).  The reference's nested ifs classify any
first/second/third character that is not A/C/G into the final else branch
(i.e. treated like T); we replicate that exactly.
"""

import numpy as np

from ..utils import COMP_TABLE

_STD_CODE = {
    "AAA": "K", "AAG": "K", "AAC": "N", "AAT": "N",
    "ACA": "T", "ACC": "T", "ACG": "T", "ACT": "T",
    "AGA": "R", "AGG": "R", "AGC": "S", "AGT": "S",
    "ATA": "I", "ATC": "I", "ATT": "I", "ATG": "M",
    "CAA": "Q", "CAG": "Q", "CAC": "H", "CAT": "H",
    "CCA": "P", "CCC": "P", "CCG": "P", "CCT": "P",
    "CGA": "R", "CGC": "R", "CGG": "R", "CGT": "R",
    "CTA": "L", "CTC": "L", "CTG": "L", "CTT": "L",
    "GAA": "E", "GAG": "E", "GAC": "D", "GAT": "D",
    "GCA": "A", "GCC": "A", "GCG": "A", "GCT": "A",
    "GGA": "G", "GGC": "G", "GGG": "G", "GGT": "G",
    "GTA": "V", "GTC": "V", "GTG": "V", "GTT": "V",
    "TAA": "_", "TAG": "_", "TAC": "Y", "TAT": "Y",
    "TCA": "S", "TCC": "S", "TCG": "S", "TCT": "S",
    "TGA": "_", "TGG": "W", "TGC": "C", "TGT": "C",
    "TTA": "L", "TTG": "L", "TTC": "F", "TTT": "F",
}

# classification of a byte for the nested-if dispatch: A->0, C->1, G->2, other->3(T)
_CLS = np.full(256, 3, dtype=np.int64)
for _i, _c in enumerate("ACG"):
    _CLS[ord(_c)] = _i
_IS_N = np.zeros(256, dtype=bool)
_IS_N[ord("N")] = True

# aa[cls_a, cls_b, cls_c], with '?'/'_' already replaced by 'A'
_AA = np.zeros((4, 4, 4), dtype=np.uint8)
for _ia, _a in enumerate("ACGT"):
    for _ib, _b in enumerate("ACGT"):
        for _ic, _c in enumerate("ACGT"):
            aa = _STD_CODE[_a + _b + _c]
            _AA[_ia, _ib, _ic] = ord("A") if aa == "_" else ord(aa)


def translate_frames(raw):
    """raw: uint8 read bytes. Returns the three frame translations as uint8
    arrays (vectorized)."""
    n = len(raw)
    cls = _CLS[raw]
    has_n = _IS_N[raw]
    out = []
    for frame in range(3):
        # codons at positions frame + 3k while frame + 3k + 2 < n
        m = max(0, -(-(n - 2 - frame) // 3)) if n - 2 > frame else 0
        a = cls[frame:frame + 3 * m:3][:m]
        b = cls[frame + 1:frame + 1 + 3 * m:3][:m]
        c = cls[frame + 2:frame + 2 + 3 * m:3][:m]
        aa = _AA[a, b, c]
        anyn = has_n[frame:frame + 3 * m:3][:m] | \
            has_n[frame + 1:frame + 1 + 3 * m:3][:m] | \
            has_n[frame + 2:frame + 2 + 3 * m:3][:m]
        out.append(np.where(anyn, np.uint8(ord("A")), aa))
    return out


# frame_table's layout (kernels/csrc/translate_frames.cu TF_*)
TABLE_FWD, TABLE_REV, TABLE_BYTES = 128, 384, 640


def frame_table(encode):
    """translate_frames' rules as one uint8 lookup table for the six-frame
    translation on the card (device_engine.translate_lanes): at 25 a + 5 b + c
    the code (`encode`: the index's alphabet) of the codon of classes a, b, c,
    where 0-3 are A, C, G, T (any byte but A, C, G, N) and 4 is N ('A', as a
    stop is); at TABLE_FWD + byte the byte's class; at TABLE_REV + byte the
    class of its complement (COMP_TABLE), for the reverse strand."""
    cls = np.where(_IS_N, 4, _CLS).astype(np.uint8)
    a, b, c = np.meshgrid(np.arange(5), np.arange(5), np.arange(5), indexing="ij")
    aa = np.where((a == 4) | (b == 4) | (c == 4), np.uint8(ord("A")), _AA[a % 4, b % 4, c % 4])
    t = np.zeros(TABLE_BYTES, np.uint8)
    t[:125] = encode[aa.reshape(-1)]
    t[TABLE_FWD:TABLE_FWD + 256] = cls
    t[TABLE_REV:TABLE_REV + 256] = cls[COMP_TABLE]
    return t
