"""The work a textured render frame asks of the card, counted from the cell,
never from the program's kernel (benchmark/harness/workcount.py's rules,
with the texel fetches beside them).

Frozen here, so that another texel layout, cache or kernel is measured
against the same work:

* the operations and bytes of a render frame as
  ``workcount.render_frame_work`` counts them (each segment against every
  primitive row; the lanes' outputs, the accumulation, the framebuffer);
* :data:`FETCHES_PER_SEGMENT` nearest-texel fetches a segment, each one
  DRAM sector of :data:`SECTOR_BYTES`: the configuration's 1.61 GB of
  texels are 32 times the card's L2, so a fetch at a scattered address
  reads at least the sector that holds its 12 bytes.

:data:`FETCHES_PER_SEGMENT` is the texel fetches (surface rows and sky)
over the segments of one frame of kernel 4's counting build
(``trace.counted``) on an NVIDIA H100 80GB HBM3: the ``textured-render``
cell's frame 0 at seed :data:`COUNTED_SEED`, :data:`COUNTED_FETCHES`
fetches (17,731,673 of surface texels, 2,634,764 of the sky) over
:data:`COUNTED_SEGMENTS` segments, 0.9223 a segment; eight other seeds
counted 0.92225-0.92243 (the cell's runs).
"""

from __future__ import annotations

from benchmark.harness import workcount

SECTOR_BYTES = 32
COUNTED_SEED = 1_000_000_007
COUNTED_FETCHES = 20_366_437
COUNTED_SEGMENTS = 22_083_017
FETCHES_PER_SEGMENT = COUNTED_FETCHES / COUNTED_SEGMENTS


def texel_bytes(segments: int) -> float:
    """The bytes the texel fetches of ``segments`` segments read at least."""
    return segments * FETCHES_PER_SEGMENT * SECTOR_BYTES


def render_frame_work(segments: int, lanes: int, pixels: int, rows) -> tuple:
    """``(ops, bytes)`` of one textured render frame and its accumulation."""
    ops, nbytes = workcount.render_frame_work(segments, lanes, pixels, rows)
    return ops, nbytes + texel_bytes(segments)
