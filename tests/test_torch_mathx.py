"""The port's utils/mathx against the reference's (fspt_tpu/utils/mathx.py)
on the same inputs, case for case with tests/test_mathx.py, and against the
same NumPy closed forms at that file's bars.

Port and reference agree to float32 rounding: rtol 1e-5 / atol 1e-6 where
the reference's own bar is looser than that, else the reference's bar."""

import numpy as np
import pytest
import torch

from fspt_tpu.utils import mathx as rx
from fspt_tpu_torch.utils import mathx as mx

CPU = "cpu"


def T(x):
    """A CPU float32 tensor of ``x``."""
    return torch.as_tensor(np.asarray(x, np.float32))


def same(got, ref, rtol=1e-5, atol=1e-6):
    """The port's result equals the reference's on the same inputs."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)
    return got


# ---------------------------------------------------------------------------
# Quaternions


def test_quat_axis_angle_roundtrip():
    rng = np.random.default_rng(0)
    axis = rng.normal(size=3)
    angle = 1.234
    q = same(mx.quat_from_axis_angle(T(axis), angle), rx.quat_from_axis_angle(axis, angle))
    ax2, ang2 = mx.quat_to_axis_angle(T(q))
    rax2, rang2 = rx.quat_to_axis_angle(q)
    same(ang2, rang2)
    same(ax2, rax2, atol=1e-5)
    np.testing.assert_allclose(float(ang2), angle, rtol=1e-5)
    np.testing.assert_allclose(ax2.numpy(), axis / np.linalg.norm(axis), rtol=1e-4, atol=1e-6)


def test_quat_rotate_matches_matrix():
    rng = np.random.default_rng(1)
    axis = rng.normal(size=3)
    angle = 0.77
    v = rng.normal(size=(5, 3)).astype(np.float32)
    q = mx.quat_from_axis_angle(T(axis), angle)
    r = same(mx.quat_to_matrix3(q), rx.quat_to_matrix3(rx.quat_from_axis_angle(axis, angle)))
    qb = torch.broadcast_to(q, (5, 4))
    out_q = same(mx.quat_rotate(qb, T(v)), rx.quat_rotate(np.asarray(qb), v), atol=1e-5)
    np.testing.assert_allclose(out_q, v @ r.T, rtol=1e-4, atol=1e-5)


def test_quat_mul_identity_and_inverse():
    rng = np.random.default_rng(2)
    q0 = rng.normal(size=4).astype(np.float32)
    q = same(mx.quat_normalize(T(q0)), rx.quat_normalize(q0))
    ident = np.array([1.0, 0, 0, 0], np.float32)
    np.testing.assert_allclose(mx.quat_mul(T(q), T(ident)).numpy(), q, atol=1e-6)
    inv = same(mx.quat_inverse(T(q)), rx.quat_inverse(q))
    qq = same(mx.quat_mul(T(q), T(inv)), rx.quat_mul(q, inv))
    np.testing.assert_allclose(qq, ident, atol=1e-5)


def test_quat_between_rotates_from_onto_to():
    rng = np.random.default_rng(3)
    f = rng.normal(size=3)
    t = rng.normal(size=3)
    q = same(mx.quat_between(T(f), T(t)), rx.quat_between(f, t), atol=1e-5)
    out = mx.quat_rotate(T(q), T(f)).numpy()
    np.testing.assert_allclose(out / np.linalg.norm(out), t / np.linalg.norm(t), atol=1e-4)


def test_quat_between_parallel_degenerate():
    v = np.array([0.0, 2.0, 0.0])
    q = same(mx.quat_between(T(v), T(v)), rx.quat_between(v, v))
    out = mx.quat_rotate(T(q), T(v)).numpy()
    np.testing.assert_allclose(out, v, atol=1e-4)


def test_quat_slerp_endpoints_and_midpoint():
    a = mx.quat_from_axis_angle(T([0, 1, 0]), 0.0)
    b = mx.quat_from_axis_angle(T([0, 1, 0]), 1.0)
    ra, rb = np.asarray(a), np.asarray(b)
    for frac in (0.0, 0.5, 1.0):
        same(mx.quat_slerp(a, b, frac), rx.quat_slerp(ra, rb, frac))
    np.testing.assert_allclose(mx.quat_slerp(a, b, 0.0).numpy(), ra, atol=1e-6)
    np.testing.assert_allclose(mx.quat_slerp(a, b, 1.0).numpy(), rb, atol=1e-6)
    expect = mx.quat_from_axis_angle(T([0, 1, 0]), 0.5).numpy()
    np.testing.assert_allclose(mx.quat_slerp(a, b, 0.5).numpy(), expect, atol=1e-5)


# ---------------------------------------------------------------------------
# Interpolation


def test_lerp_and_eases():
    assert float(mx.lerp(2.0, 4.0, 0.25)) == pytest.approx(2.5)
    assert float(mx.ease_in(0.0, 1.0, 0.5)) == pytest.approx(0.25)
    fracs = np.linspace(0, 1, 21).astype(np.float32)
    vals = same(mx.ease_over(0.0, 1.0, T(fracs)), rx.ease_over(0.0, 1.0, fracs))
    # ease_over hits its endpoints exactly (interpolate.h:171-199) ...
    assert float(mx.ease_over(1.0, 3.0, T(0.0))) == pytest.approx(1.0, abs=1e-5)
    assert float(mx.ease_over(1.0, 3.0, T(1.0))) == pytest.approx(3.0, abs=1e-5)
    # ... and overshoots in between.
    assert vals.max() > 1.01


def test_slerp_unit_vectors_great_arc():
    a = np.array([1.0, 0.0, 0.0])
    b = np.array([0.0, 1.0, 0.0])
    for frac in (0.0, 0.5, 1.0):
        same(mx.slerp(T(a), T(b), frac), rx.slerp(a, b, frac))
    s2 = np.sqrt(0.5)
    np.testing.assert_allclose(mx.slerp(T(a), T(b), 0.5).numpy(), [s2, s2, 0.0], atol=1e-5)
    np.testing.assert_allclose(mx.slerp(T(a), T(b), 0.0).numpy(), a, atol=1e-6)
    np.testing.assert_allclose(mx.slerp(T(a), T(b), 1.0).numpy(), b, atol=1e-6)


def test_slerp_interpolates_length():
    a = np.array([2.0, 0.0, 0.0])
    b = np.array([0.0, 4.0, 0.0])
    mid = same(mx.slerp(T(a), T(b), 0.5), rx.slerp(a, b, 0.5))
    assert np.linalg.norm(mid) == pytest.approx(3.0, rel=1e-5)


def test_color_lerp_inside_and_outside():
    p0, p1, p2 = np.array([0.0, 0, 0]), np.array([1.0, 0, 0]), np.array([0.0, 1, 0])
    c0, c1, c2 = np.array([1.0, 0, 0]), np.array([0.0, 1, 0]), np.array([0.0, 0, 1])
    args = (p0, c0, p1, c1, p2, c2)
    for pos in ((p0 + p1 + p2) / 3, np.array([5.0, 5.0, 0.0]), p1):
        same(mx.color_lerp(*map(T, args), T(pos)), rx.color_lerp(*args, pos))
    centroid = mx.color_lerp(*map(T, args), T((p0 + p1 + p2) / 3)).numpy()
    np.testing.assert_allclose(centroid, [1 / 3, 1 / 3, 1 / 3], atol=1e-5)
    np.testing.assert_allclose(mx.color_lerp(*map(T, args), T([5.0, 5.0, 0.0])).numpy(), 0.0)
    np.testing.assert_allclose(mx.color_lerp(*map(T, args), T(p1)).numpy(), c1, atol=1e-5)


# ---------------------------------------------------------------------------
# Bezier curves / paths


def _de_casteljau_np(control, t):
    pts = [np.asarray(c, np.float64) for c in control]
    while len(pts) > 1:
        pts = [a * (1 - t) + b * t for a, b in zip(pts[:-1], pts[1:])]
    return pts[0]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_bezier_matches_de_casteljau(k):
    rng = np.random.default_rng(k)
    control = rng.normal(size=(k, 3))
    ts = np.linspace(0, 1, 9)
    got = same(mx.eval_bezier(T(control), T(ts)), rx.eval_bezier(control, ts))
    want = np.stack([_de_casteljau_np(control, t) for t in ts])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_bezier_clamps_t():
    control = np.array([[0.0, 0, 0], [1.0, 0, 0]])
    for t, want in ((-3.0, [0, 0, 0]), (7.0, [1, 0, 0])):
        got = same(mx.eval_bezier(T(control), t), rx.eval_bezier(control, t))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_bezier_rejects_bad_order():
    with pytest.raises(ValueError):
        rx.eval_bezier(np.zeros((5, 3)), 0.5)
    with pytest.raises(ValueError, match="2-4 control points"):
        mx.eval_bezier(T(np.zeros((5, 3))), 0.5)


def test_path_buckets_t_per_curve():
    # Two linear segments: (0,0,0)->(1,0,0) then (1,0,0)->(1,1,0).
    curves = [np.array([[0.0, 0, 0], [1.0, 0, 0]]), np.array([[1.0, 0, 0], [1.0, 1, 0]])]
    for t, want, atol in ((0.25, [0.5, 0, 0], 1e-5), (0.75, [1.0, 0.5, 0], 1e-5),
                          (1.0, [1.0, 1.0, 0], 1e-4)):
        got = same(mx.eval_path([T(c) for c in curves], T(t)), rx.eval_path(curves, t))
        np.testing.assert_allclose(got, want, atol=atol)
    ts = np.linspace(0, 1, 11, dtype=np.float32)  # a batch of t
    same(mx.eval_path([T(c) for c in curves], T(ts)), rx.eval_path(curves, ts))


# ---------------------------------------------------------------------------
# Statistics / regression


def test_statistics_match_numpy_population_forms():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(same(mx.mean(T(x)), rx.mean(x)), x.mean(0), rtol=1e-5)
    np.testing.assert_allclose(same(mx.variance(T(x)), rx.variance(x)), x.var(0), rtol=1e-4)
    np.testing.assert_allclose(same(mx.deviation(T(x)), rx.deviation(x)), x.std(0),
                               rtol=1e-4)
    want_cov = ((x - x.mean(0)) * (y - y.mean(0))).mean(0)
    np.testing.assert_allclose(same(mx.covariance(T(x), T(y)), rx.covariance(x, y)),
                               want_cov, rtol=1e-4, atol=1e-6)


def test_linear_squares_matches_polyfit():
    rng = np.random.default_rng(8)
    x = rng.uniform(-3, 5, size=32)
    y = 2.5 * x - 1.25 + rng.normal(scale=0.3, size=32)
    pts = np.stack([x, y], axis=-1).astype(np.float32)
    start, end = mx.linear_squares(T(pts))
    rstart, rend = rx.linear_squares(pts)
    start, end = same(start, rstart, rtol=1e-4), same(end, rend, rtol=1e-4)
    m, b = np.polyfit(x, y, 1)
    np.testing.assert_allclose(start[0], x.min(), rtol=1e-5)
    np.testing.assert_allclose(end[0], x.max(), rtol=1e-5)
    np.testing.assert_allclose(start[1], m * x.min() + b, rtol=1e-3)
    np.testing.assert_allclose(end[1], m * x.max() + b, rtol=1e-3)


# ---------------------------------------------------------------------------
# Solvers


def test_solve_quadratic_two_one_zero_roots():
    roots, count = mx.solve_quadratic(T(1.0), T(-3.0), T(2.0))  # (t-1)(t-2)
    rroots, rcount = rx.solve_quadratic(1.0, -3.0, 2.0)
    same(roots, rroots)
    assert int(count) == int(rcount) == 2
    # Root ordering matches solver.h:67-68: (-b+sqrt)/2a first.
    np.testing.assert_allclose(roots.numpy(), [2.0, 1.0], atol=1e-5)
    assert int(mx.solve_quadratic(T(1.0), T(-2.0), T(1.0))[1]) == 1  # (t-1)^2
    assert int(mx.solve_quadratic(T(1.0), T(0.0), T(1.0))[1]) == 0  # no real roots


def test_solve_quadratic_batched():
    a = np.ones(3, np.float32)
    b = np.array([-3.0, -2.0, 0.0], np.float32)
    c = np.array([2.0, 1.0, 1.0], np.float32)
    roots, count = mx.solve_quadratic(T(a), T(b), T(c))
    rroots, rcount = rx.solve_quadratic(a, b, c)
    same(roots, rroots)
    assert list(count.numpy()) == list(np.asarray(rcount)) == [2, 1, 0]
    assert np.all(np.isfinite(roots.numpy()))


@pytest.mark.parametrize("coeffs", [
    (1.0, -6.0, 11.0, -6.0),   # roots 1,2,3
    (2.0, 0.0, -8.0, 0.0),     # roots -2,0,2 (scaled leading coeff)
    (1.0, 0.0, 0.0, -8.0),     # single real root 2
    (1.0, -3.0, 3.0, -1.0),    # triple root 1
])
def test_solve_cubic_matches_numpy_roots(coeffs):
    roots, count = mx.solve_cubic(*map(T, coeffs))
    rroots, rcount = rx.solve_cubic(*coeffs)
    assert int(count) == int(rcount)
    same(roots, rroots, rtol=1e-4, atol=1e-4)
    got = np.sort(roots.numpy()[: int(count)])
    want = np.roots(coeffs)
    want = np.sort(want[np.abs(want.imag) < 1e-6].real)
    e, a, b, c = coeffs
    np.testing.assert_allclose(e * got**3 + a * got**2 + b * got + c, 0.0, atol=1e-3)
    assert got.min() >= want.min() - 1e-3 and got.max() <= want.max() + 1e-3


# ---------------------------------------------------------------------------
# Hash


def test_hash_bytes_matches_reference_formula():
    def ref_hash(data):
        h = 5381
        for ch in data:
            h = ((h << 5) + h + (h << 16) * ch * ch) & 0xFFFFFFFF
        return h

    for data in (b"", b"a", b"hello world", bytes(range(256))):
        assert mx.hash_bytes(data) == rx.hash_bytes(data) == ref_hash(data)


# ---------------------------------------------------------------------------
# mat4 helpers


def test_mat4_trs_compose_and_apply():
    t = same(mx.mat4_translation(T([1.0, 2.0, 3.0])), rx.mat4_translation([1.0, 2.0, 3.0]))
    s = same(mx.mat4_scale(T([2.0, 2.0, 2.0])), rx.mat4_scale([2.0, 2.0, 2.0]))
    same(mx.mat4_identity(device=CPU), rx.mat4_identity())
    p = np.array([[1.0, 1.0, 1.0]], np.float32)
    out = same(mx.transform_points(T(t @ s), T(p)), rx.transform_points(t @ s, p))
    np.testing.assert_allclose(out, [[3.0, 4.0, 5.0]], atol=1e-6)


def test_mat4_rotation_matches_quat():
    axis, angle = [0.3, -0.5, 0.81], 0.9
    r = same(mx.mat4_rotation(T(axis), angle), rx.mat4_rotation(axis, angle))
    v = np.array([1.0, 2.0, -0.5], np.float32)
    got = same(mx.transform_dirs(T(r), T(v)), rx.transform_dirs(r, v))
    want = mx.quat_rotate(mx.quat_from_axis_angle(T(axis), angle), T(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mat4_look_at_basis_is_orthonormal_and_faces_target():
    m = same(mx.mat4_look_at(T([0.0, 0, -10]), T([0.0, 0, 0])),
             rx.mat4_look_at([0.0, 0, -10], [0.0, 0, 0]))
    basis = m[:3, :3]
    np.testing.assert_allclose(basis.T @ basis, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(basis[:, 2], [0, 0, 1], atol=1e-6)  # view +z
    np.testing.assert_allclose(m[:3, 3], [0, 0, -10], atol=1e-6)


def test_mat4_perspective_maps_near_far():
    znear, zfar = 1.0, 100.0
    args = (np.deg2rad(45.0), 4 / 3, znear, zfar)
    m = same(mx.mat4_perspective(*args, device=CPU), rx.mat4_perspective(*args))
    near_pt = mx.transform_points(T(m), T([0.0, 0, znear])).numpy()
    far_pt = mx.transform_points(T(m), T([0.0, 0, zfar])).numpy()
    np.testing.assert_allclose(near_pt[2], 0.0, atol=1e-5)
    np.testing.assert_allclose(far_pt[2], 1.0, atol=1e-5)


def test_mat4_inverse_roundtrip():
    m = (mx.mat4_translation(T([1.0, -2, 0.5])) @ mx.mat4_rotation(T([0, 1, 0]), 0.4)
         @ mx.mat4_scale(T([2.0, 3.0, 4.0])))
    inv = same(mx.mat4_inverse(m), rx.mat4_inverse(m.numpy()))
    np.testing.assert_allclose(inv @ m.numpy(), np.eye(4), atol=1e-5)


def test_array_likes_follow_the_device_rule():
    """Tensors keep their device; array-likes go to ``device``, the card
    by default (config.resolve_device)."""
    assert mx.quat_from_axis_angle([0.0, 1.0, 0.0], 0.3, device=CPU).device.type == "cpu"
    assert mx.mat4_identity(device=CPU).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mx.mat4_identity()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mx.eval_bezier([[0.0, 0, 0], [1.0, 0, 0]], 0.5)
