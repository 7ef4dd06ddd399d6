"""Scoring / algorithm options — the analogue of bwa-0.7.8's mem_opt_t.

The reference hardware hardcodes the substitution matrix at +1/-4 (-1 vs N)
(`sw_pe_array_sw_extend.v:1915-1940`, the bwa `-Ma` defaults)
and takes gap penalties, band width and clip penalties per batch in header
words 0-1 (SURVEY.md §2.3).  Here everything is runtime-configurable, with
defaults equal to `bwa-0.7.8 mem -Ma`.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def build_mat(a: int, b: int, nrow: int = 5) -> np.ndarray:
    """Substitution matrix: +a match, -b mismatch, -1 vs N (bwa_fill_scmat).

    Matches the hardware's hardcoded 25-entry mux table
    (sw_pe_array_sw_extend.v:1915-1940, values 0x01/0xFC/0xFF
    for a=1, b=4).
    """
    mat = np.full((nrow, nrow), -b, dtype=np.int8)
    np.fill_diagonal(mat, a)
    mat[nrow - 1, :] = -1  # N row
    mat[:, nrow - 1] = -1  # N column
    return mat


@dataclasses.dataclass(frozen=True)
class MemOptions:
    """bwa-0.7.8 `mem_opt_t` defaults (with -M and -a behaviour as flags)."""

    a: int = 1            # match score
    b: int = 4            # mismatch penalty
    o_del: int = 6        # gap open (deletion)
    e_del: int = 1        # gap extend (deletion)
    o_ins: int = 6        # gap open (insertion)
    e_ins: int = 1        # gap extend (insertion)
    w: int = 100          # band width
    zdrop: int = 100      # Z-dropoff (0.7.8 default; reference FPGA omits it)
    pen_clip5: int = 5    # 5'-end clipping penalty
    pen_clip3: int = 5    # 3'-end clipping penalty
    pen_unpaired: int = 17
    min_seed_len: int = 19
    split_factor: float = 1.5
    split_width: int = 10
    max_occ: int = 500    # skip seeds with occ > max_occ (0.7.8: maxOcc 500... see mem.c)
    max_chain_gap: int = 10000
    drop_ratio: float = 0.50
    min_chain_weight: int = 0
    mask_level: float = 0.50
    chain_drop_ratio: float = 0.50
    mapq_coef_len: float = 50.0
    T: int = 30           # minimum score to output
    flag_M: bool = True   # -M: mark shorter split hits as secondary
    flag_a: bool = True   # -a: output all alignments (the README invocation is -Ma)
    max_matesw: int = 100
    max_ins: int = 10000  # maximum insert size for pairing
    skip_pairing: bool = False  # -P: emit both ends SE-style with PE
    #                             flags (bwa MEM_F_NOPAIRING)
    # -I mean[,std[,max[,min]]]: explicit FR insert-size distribution
    # (skips mem_pestat); <= 0 = infer from the batch
    pe_mean: float = -1.0
    pe_std: float = -1.0
    pe_max: int = -1
    pe_min: int = -1

    @property
    def mat(self) -> np.ndarray:
        return build_mat(self.a, self.b)

    @property
    def oe_del(self) -> int:
        return self.o_del + self.e_del

    @property
    def oe_ins(self) -> int:
        return self.o_ins + self.e_ins

    @property
    def mapq_coef_fac(self) -> float:
        return float(np.log(self.mapq_coef_len))


# 4-bit base codes used in the task payload (SURVEY.md §2.3: payload is 4-bit
# symbols, 8 per u32, MSB-first).  Codes 0-3 = A,C,G,T; 4 = N (ambiguous).
BASE_A, BASE_C, BASE_G, BASE_T, BASE_N = 0, 1, 2, 3, 4

# Hardware capacity limits (SURVEY.md §2.3 "Capacity limits implied") — we keep
# them as the *defaults* of the packed task format but they are configurable.
MAX_QLEN_SIDE = 255    # 8-bit qlen fields, eh_arr depth 256
MAX_TLEN_SIDE = 2047   # 11-bit tlen fields
MAX_TASK_SYMBOLS = 2048  # query_mem depth
