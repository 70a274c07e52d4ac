"""The yardstick of the kernels' work: the cells and bytes a problem
needs, and the card's peaks that price them.

Cells are counted from the data, not from padded shapes, as a frozen copy
of the port's ``ops/costs.py::needed_cells``, so no change to the program
moves the count.

Peaks: NVIDIA H100 SXM (data sheet, 700 W), 132 SMs at a 1.98 GHz boost
clock, 64 int32 lanes an SM, HBM3 at 3.35 TB/s.  A cell's add and max
can run as DPX ``s16x2`` operations on two 16-bit halves a lane, the
fastest CUDA-core route, so no kernel of today's kind (int32 or 16-bit
arithmetic on the CUDA cores) can pass one cell a half-lane a clock.  A
formulation on the tensor cores would do other operations at another
peak, and needs a recount.
"""

from __future__ import annotations

SMS = 132
INT32_LANES = 64
CLOCK_HZ = 1.98e9
DPX_CELLS_PER_S = SMS * INT32_LANES * CLOCK_HZ * 2
HBM_BYTES_PER_S = 3.35e12


def needed_cells(len1: int, lens) -> int:
    """Sum of ``(len1 - len2) * len2`` over the searchable Seq2s."""
    return sum((len1 - int(n)) * int(n) for n in lens if 0 < int(n) < len1)


def input_bytes(len1: int, lens) -> int:
    """What a problem must read and write once: its characters, four
    int32 weights, and three int32 per answer."""
    return len1 + sum(int(n) for n in lens) + 16 + 12 * len(lens)


def least_seconds(cells: int, nbytes: int) -> float:
    """The least time the card could take: the larger of the cells at the
    DPX rate and the bytes at the HBM rate."""
    return max(cells / DPX_CELLS_PER_S, nbytes / HBM_BYTES_PER_S)
