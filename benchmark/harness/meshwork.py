"""The work a mesh render frame asks of the card, counted from the cell,
never from the program's tree or kernel (benchmark/harness/workcount.py's
rules, with a triangle mesh beside the primitive rows).

Frozen here, so that another tree, walk or kernel is measured against the
same work:

* a segment walks a binary tree over the mesh's triangles with
  :data:`TRIANGLES_PER_LEAF` a leaf: at least ``2·⌈log2(T /
  TRIANGLES_PER_LEAF)⌉`` box tests (a root-to-leaf path and its siblings)
  and :data:`TRIANGLE_TESTS_PER_SEGMENT` triangle tests (one leaf), each at
  the frozen operation counts :data:`OPS_PER_BOX_TEST` and
  ``workcount.OPS_PER_TEST["triangle"]``, besides every primitive row;
* the bytes of a render frame as ``workcount.render_frame_work`` counts
  them (the lanes' outputs, the accumulation, the framebuffer).

T = 99,458 gives 30 box tests and 4 triangle tests a segment.
"""

from __future__ import annotations

import math

from benchmark.harness import workcount

#: Float operations of one segment-box slab test (six subtractions and
#: products, the near and far picks and their joins, the three compares).
OPS_PER_BOX_TEST = 30
TRIANGLES_PER_LEAF = 4
TRIANGLE_TESTS_PER_SEGMENT = 4


def box_tests(n_triangles: int) -> int:
    """Box tests a segment needs at least in a tree over ``n_triangles``."""
    leaves = max(1, math.ceil(n_triangles / TRIANGLES_PER_LEAF))
    return 2 * math.ceil(math.log2(leaves)) if leaves > 1 else 0


def segment_ops(rows, n_triangles: int) -> int:
    """Operations one segment needs against the rows and the mesh."""
    return (workcount.segment_ops(rows) + box_tests(n_triangles) * OPS_PER_BOX_TEST
            + TRIANGLE_TESTS_PER_SEGMENT * workcount.OPS_PER_TEST["triangle"])


def render_frame_work(segments: int, lanes: int, pixels: int, rows, n_triangles: int) -> tuple:
    """``(ops, bytes)`` of one mesh render frame and its accumulation."""
    _, nbytes = workcount.render_frame_work(segments, lanes, pixels, rows)
    return segments * segment_ops(rows, n_triangles), nbytes
