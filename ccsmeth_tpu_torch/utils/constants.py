"""Shared constants of the ccsmeth-tpu engine.

Semantics-parity notes cite the reference implementation
(ccsmeth/utils/process_utils.py) by line.
"""

from __future__ import annotations

import numpy as np

# --- base alphabets (reference process_utils.py:12-41) ---------------------------------
BASEPAIRS = {
    "A": "T", "C": "G", "G": "C", "T": "A", "N": "N",
    "W": "W", "S": "S", "M": "K", "K": "M", "R": "Y",
    "Y": "R", "B": "V", "V": "B", "D": "H", "H": "D",
    "Z": "Z",
}
BASEPAIRS_RNA = {
    "A": "U", "C": "G", "G": "C", "U": "A", "N": "N",
    "W": "W", "S": "S", "M": "K", "K": "M", "R": "Y",
    "Y": "R", "B": "V", "V": "B", "D": "H", "H": "D",
    "Z": "Z",
}

# 5-way base coding: everything ambiguous folds to N=4 (process_utils.py:26-30)
BASE2CODE_DNA = {
    "A": 0, "C": 1, "G": 2, "T": 3, "N": 4,
    "W": 4, "S": 4, "M": 4, "K": 4, "R": 4,
    "Y": 4, "B": 4, "V": 4, "D": 4, "H": 4,
    "Z": 4,
}
CODE2BASE_DNA = {0: "A", 1: "C", 2: "G", 3: "T", 4: "N"}

IUPAC_ALPHABETS = {
    "A": ["A"], "T": ["T"], "C": ["C"], "G": ["G"],
    "R": ["A", "G"], "M": ["A", "C"], "S": ["C", "G"],
    "Y": ["C", "T"], "K": ["G", "T"], "W": ["A", "T"],
    "B": ["C", "G", "T"], "D": ["A", "G", "T"],
    "H": ["A", "C", "T"], "V": ["A", "C", "G"],
    "N": ["A", "C", "G", "T"],
}
IUPAC_ALPHABETS_RNA = {
    "A": ["A"], "C": ["C"], "G": ["G"], "U": ["U"],
    "R": ["A", "G"], "M": ["A", "C"], "S": ["C", "G"],
    "Y": ["C", "U"], "K": ["G", "U"], "W": ["A", "U"],
    "B": ["C", "G", "U"], "D": ["A", "G", "U"],
    "H": ["A", "C", "U"], "V": ["A", "C", "G"],
    "N": ["A", "C", "G", "U"],
}

CODE2CIGAR = "MIDNSHP=XB"
CIGAR2CODE = {c: i for i, c in enumerate(CODE2CIGAR)}

# --- model/embedding dims (process_utils.py:64-73) -------------------------------------
N_VOCAB = 5
MAX_KINETICS = 952
MAX_PASSES = 30
MAX_MAP = 8
NEMBED_BASE = 8
NEMBED_KINETICS = 8
NEMBED_PASSES = 4
NEMBED_MAP = 4
NEMBED_SN = 4
NEMBED_KINETICS_STD = 8

DEFAULT_REF_LOC = -1

# --- byte-level lookup tables (vectorization aids; ours, not in reference) -------------
# ASCII byte -> 5-way base code (uppercase + lowercase), unknown bytes -> 4 (N)
BYTE2CODE = np.full(256, 4, dtype=np.uint8)
for _b, _c in BASE2CODE_DNA.items():
    BYTE2CODE[ord(_b)] = _c
    BYTE2CODE[ord(_b.lower())] = _c

# ASCII byte -> complement ASCII byte (DNA); preserves case mapping to uppercase
# like reference complement_seq, unknown letters -> 'N' (process_utils.py:100-118)
BYTE_COMPLEMENT = np.full(256, ord("N"), dtype=np.uint8)
for _b, _c in BASEPAIRS.items():
    BYTE_COMPLEMENT[ord(_b)] = ord(_c)
    BYTE_COMPLEMENT[ord(_b.lower())] = ord(_c)

CODE_COMPLEMENT = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N

# code for each base in SEQ_ORDER "ACGT" (process_utils.py:60-61) used by sn features
SEQ_ORDER = "ACGT"
SEQ_ENCODE = {c: i for i, c in enumerate(SEQ_ORDER)}
