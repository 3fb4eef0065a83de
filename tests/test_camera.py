"""Tests for camera derivation (camera.rs:293-350) and motion ops."""

import math

import jax.numpy as jnp
import numpy as np

from gpu_ray_tracing.models import camera as cam


def _np_derive(look_from, look_at, vup, fov, defocus_angle, focus_dist, w_px, h_px):
    """Independent numpy float64 re-derivation of camera.rs:293-350."""
    look_from = np.asarray(look_from, float)
    look_at = np.asarray(look_at, float)
    vup = np.asarray(vup, float)
    aspect = w_px / h_px
    theta = math.radians(fov)
    h = math.tan(theta / 2.0)
    vh = 2.0 * h * focus_dist
    vw = vh * aspect
    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    viewport_u = vw * u
    viewport_v = -vh * v
    pdu = viewport_u / w_px
    pdv = viewport_v / h_px
    ul = look_from - focus_dist * w - viewport_u / 2.0 - viewport_v / 2.0
    dr = focus_dist * math.tan(math.radians(defocus_angle / 2.0))
    return dict(
        center=look_from, upper_left=ul, pdu=pdu, pdv=pdv,
        disk_u=u * dr, disk_v=v * dr,
    )


def test_derive_matches_reference_math_default_settings():
    s = cam.CameraSettings.default()
    got = cam.derive_camera(s, 1280, 720)
    want = _np_derive([13, 2, 3], [0, 0, 0], [0, 1, 0], 20.0, 0.6, 10.0, 1280, 720)
    np.testing.assert_allclose(got.center, want["center"], rtol=1e-5)
    np.testing.assert_allclose(got.viewport_upper_left, want["upper_left"], rtol=1e-4)
    np.testing.assert_allclose(got.pixel_delta_u, want["pdu"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.pixel_delta_v, want["pdv"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.defocus_disk_u, want["disk_u"], rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.defocus_disk_v, want["disk_v"], rtol=1e-4, atol=1e-7)


def test_viewport_geometry_spans_frustum():
    """upper_left + W*pdu + H*pdv must mirror upper_left about the view axis."""
    s = cam.CameraSettings.default()
    c = cam.derive_camera(s, 640, 480)
    lower_right = (
        np.asarray(c.viewport_upper_left)
        + 640 * np.asarray(c.pixel_delta_u)
        + 480 * np.asarray(c.pixel_delta_v)
    )
    center_of_plane = (np.asarray(c.viewport_upper_left) + lower_right) / 2.0
    # The viewport center sits focus_distance along -w from the camera center.
    w = np.asarray(s.look_from - s.look_at, float)
    w /= np.linalg.norm(w)
    expected = np.asarray(s.look_from, float) - 10.0 * w
    np.testing.assert_allclose(center_of_plane, expected, atol=1e-4)


def test_zero_defocus_disables_lens():
    s = cam.CameraSettings.default().replace(defocus_angle=jnp.float32(0.0))
    c = cam.derive_camera(s, 100, 100)
    np.testing.assert_allclose(np.asarray(c.defocus_disk_u), 0.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(c.defocus_disk_v), 0.0, atol=1e-8)


def test_dolly_moves_away_from_target():
    """Reference 'forward' points from look_at toward look_from
    (camera.rs:134), so positive dolly increases distance."""
    s = cam.CameraSettings.default()
    d0 = float(jnp.linalg.norm(s.look_from - s.look_at))
    s2 = cam.dolly(s, 1.0)
    d1 = float(jnp.linalg.norm(s2.look_from - s2.look_at))
    assert abs(d1 - (d0 + 1.0)) < 1e-4


def test_strafe_preserves_height_and_distance_to_axis():
    s = cam.CameraSettings.default()
    s2 = cam.strafe(s, 0.5)
    assert abs(float(s2.look_from[1] - s.look_from[1])) < 1e-6  # right is horizontal


def test_elevate():
    s = cam.CameraSettings.default()
    s2 = cam.elevate(s, 2.0)
    np.testing.assert_allclose(
        np.asarray(s2.look_from), np.asarray(s.look_from) + [0, 2, 0], atol=1e-6
    )


def test_orbit_yaw_preserves_radius_and_height():
    s = cam.CameraSettings.default()
    s2 = cam.orbit_yaw(s, 0.3)
    r0 = np.linalg.norm(np.asarray(s.look_from - s.look_at))
    r1 = np.linalg.norm(np.asarray(s2.look_from - s2.look_at))
    assert abs(r0 - r1) < 1e-4
    assert abs(float(s2.look_from[1] - s.look_from[1])) < 1e-5
    # Full revolution returns to start.
    s_full = s
    for _ in range(8):
        s_full = cam.orbit_yaw(s_full, 2.0 * math.pi / 8)
    np.testing.assert_allclose(np.asarray(s_full.look_from), np.asarray(s.look_from), atol=1e-3)


def test_orbit_pitch_flip_guard():
    """Pitch blocks when |dot(direction, Y)| would exceed 0.95 (camera.rs:221)."""
    s = cam.CameraSettings.default()
    # Drive pitch up far past vertical; the guard must keep it below 0.95.
    for _ in range(100):
        s = cam.orbit_pitch(s, 0.05)
    direction = np.asarray(s.look_from - s.look_at, float)
    direction /= np.linalg.norm(direction)
    assert abs(direction[1]) < 0.95


def test_zoom_clamps_fov():
    s = cam.CameraSettings.default()
    assert float(cam.zoom(s, -100.0).field_of_view) == 10.0
    assert float(cam.zoom(s, +500.0).field_of_view) == 120.0
    assert abs(float(cam.zoom(s, 5.0).field_of_view) - 25.0) < 1e-5


def test_degenerate_camera_rejected_eagerly():
    """look_from == look_at (or vup parallel to the gaze) rendered silent
    NaNs; eager derive_camera / the CLI now reject them up front."""
    import pytest

    from gpu_ray_tracing.models.camera import (
        CameraSettings,
        derive_camera,
        validate_camera,
    )

    same = CameraSettings.default().replace(
        look_from=jnp.asarray([1.0, 2.0, 3.0]),
        look_at=jnp.asarray([1.0, 2.0, 3.0]),
    )
    with pytest.raises(ValueError, match="look_from == look_at"):
        derive_camera(same, 32, 24)

    parallel_up = CameraSettings.default().replace(
        look_from=jnp.asarray([0.0, 1.0, 0.0]),
        look_at=jnp.asarray([0.0, 0.0, 0.0]),
        vup=jnp.asarray([0.0, 2.0, 0.0]),
    )
    with pytest.raises(ValueError, match="parallel"):
        validate_camera(parallel_up)
