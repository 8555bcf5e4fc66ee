"""The work a cell asks of the card, counted from the cell, never from a
kernel, and the card's published peaks.

Frozen here, so that a later change that renames, fuses or replaces a kernel
is still measured against the same work:

* :data:`OPS_PER_TEST` — float operations (add, mul, div, sqrt, compare,
  select) one segment spends on one primitive row before it knows whether
  the row is hit (the port's ``ops/cuda_trace.OPS_PER_TEST``, counted from
  the intersection body).  Work done only on a hit is left out, so a
  segment's sum over the rows is a lower bound.
* Bytes a render frame must move at least: each lane's outputs written
  once (radiance, normal, depth, material, segment count), read once by the
  accumulation, and the framebuffer read and written once.
* A recovery step: both buffers' segments, each against every row; where a
  field moves geometry (a scalar such as a metal's roughness, or the camera)
  the reverse sweep adds at least the adjoint of the winner's test, counted
  as twice the cheapest row test of the scene; the target is read once.
"""

from __future__ import annotations

OPS_PER_TEST = {"sphere": 36, "plane": 19, "disc": 19, "quad": 19, "cuboid_face": 19,
                "triangle": 55}

#: Written once per lane by a render: radiance 12, normal 12, depth 4,
#: material 4, segment count 4.
LANE_OUTPUT_BYTES = 36
#: Read once per lane by the accumulation: radiance, normal, depth, material.
ACCUMULATE_LANE_BYTES = 32
#: One framebuffer pixel: mean 12, m2 12, count 4, normal 12, depth 4, mat 4.
FRAMEBUFFER_PIXEL_BYTES = 48
#: Fields whose gradient runs through the geometry of the path.
GEOMETRIC_FIELDS = ("param", "ior", "reflectivity", "frost", "camera")
#: The reverse sweep's operations per segment, in units of the cheapest row
#: test.
BACKWARD_TESTS_PER_SEGMENT = 2

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def segment_ops(rows) -> int:
    """Operations one segment needs against every row of the table."""
    return sum(OPS_PER_TEST[r["kind"]] for r in rows)


def render_frame_work(segments: int, lanes: int, pixels: int, rows) -> tuple:
    """``(ops, bytes)`` of one render frame and its accumulation."""
    ops = segments * segment_ops(rows)
    nbytes = (lanes * (LANE_OUTPUT_BYTES + ACCUMULATE_LANE_BYTES)
              + pixels * 2 * FRAMEBUFFER_PIXEL_BYTES)
    return ops, nbytes


def recover_step_work(segments: float, pixels: int, rows, fields) -> tuple:
    """``(ops, bytes)`` of one recovery step whose two buffers traced
    ``segments`` segments."""
    per_segment = segment_ops(rows)
    if any(f in GEOMETRIC_FIELDS for f in fields):
        per_segment += BACKWARD_TESTS_PER_SEGMENT * min(OPS_PER_TEST[r["kind"]] for r in rows)
    return segments * per_segment, pixels * 12


def least_time(ops: float, nbytes: float) -> tuple:
    """The least seconds the card could take, and which bound sets it."""
    t_ops = ops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
