"""The port's live preview (render/preview.py) on the CPU, served on
127.0.0.1 only, every read with its own timeout.

* The reference's stream-and-control test (tests/test_aux.py:166-205) on
  the port.
* The fixed design (the reference's ``next_frame`` holds the lock for the
  whole render, and each ``/stream`` client advances the session): with
  the render thread held inside a frame (a session whose ``_render`` waits
  on a semaphore), ``/ctl`` answers within 2 s; two stream clients see the
  same frames and the session advances once per frame; an orbit during a
  frame drops that frame, so the framebuffer holds only frames rendered
  from the new camera.
"""

import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from fspt_tpu_torch.config import RenderConfig
from fspt_tpu_torch.interactive import RenderSession
from fspt_tpu_torch.render import framebuffer as fb_mod
from fspt_tpu_torch.render.dispatch import make_scene_step
from fspt_tpu_torch.render.preview import BOUNDARY, PreviewServer
from fspt_tpu_torch.scene import samples

CPU = torch.device("cpu")
CFG = RenderConfig(width=16, height=12, spp=1, max_depth=2)
TIMEOUT = 30


class GatedSession(RenderSession):
    """A session whose frames wait for the test: ``entered`` is released
    as a render starts, and the render goes on once ``gate`` is released."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.entered = threading.Semaphore(0)
        self.gate = threading.Semaphore(0)

    def _render(self, *args, **kwargs):
        self.entered.release()
        assert self.gate.acquire(timeout=TIMEOUT), "the test never released the frame"
        return super()._render(*args, **kwargs)


def _session(cls=RenderSession):
    return cls(samples.build("flagship", device=CPU), CFG, seed=3, device=CPU)


@pytest.fixture
def serve():
    """Start a PreviewServer on a free localhost port; shut it down after."""
    started = []

    def start(session):
        srv = PreviewServer(session, host="127.0.0.1", port=0)
        threading.Thread(target=srv.httpd.serve_forever, daemon=True).start()
        started.append(srv)
        return srv, f"http://{srv.host}:{srv.port}"

    yield start
    for srv in started:
        if isinstance(srv.session, GatedSession):
            srv.session.gate.release(1000)
        srv.shutdown()


def _read_part(r):
    """The next ``(X-Frame, png)`` part of a multipart stream."""
    line = r.readline()
    while line.strip() != b"--" + BOUNDARY:
        assert line, "stream ended before a frame"
        line = r.readline()
    headers = {}
    for line in iter(r.readline, b"\r\n"):
        key, value = line.split(b":", 1)
        headers[key.strip().lower()] = value.strip()
    png = r.read(int(headers[b"content-length"]))
    assert headers[b"content-type"] == b"image/png" and png.startswith(b"\x89PNG\r\n\x1a\n")
    return int(headers[b"x-frame"]), png


def _ctl(base, query):
    return urllib.request.urlopen(f"{base}/ctl?{query}", timeout=TIMEOUT).read()


def test_preview_server_streams_and_controls(serve):
    srv, base = serve(_session())
    page = urllib.request.urlopen(f"{base}/", timeout=TIMEOUT).read()
    assert b"/stream" in page and b"16" in page

    with urllib.request.urlopen(f"{base}/stream", timeout=TIMEOUT) as r:
        assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
        seq, _ = _read_part(r)
    assert seq >= 1 and srv.session.frame >= 1

    old_origin = srv.session.camera.origin.numpy().copy()
    assert b"camera origin" in _ctl(base, "yaw=0.3")
    assert not np.allclose(srv.session.camera.origin.numpy(), old_origin)
    assert b"focus distance" in _ctl(base, "focus_x=8&focus_y=6")
    assert b"fast_render=True" in _ctl(base, "fast=1")
    assert srv.session.fast_render


def test_ctl_answers_while_a_frame_is_in_flight(serve):
    srv, base = serve(_session(GatedSession))
    with urllib.request.urlopen(f"{base}/stream", timeout=TIMEOUT):
        assert srv.session.entered.acquire(timeout=TIMEOUT)  # a frame is in flight
        t0 = time.perf_counter()
        msg = urllib.request.urlopen(f"{base}/ctl?yaw=0.3", timeout=2).read()
        assert time.perf_counter() - t0 < 2.0
        assert b"camera origin" in msg
        assert srv.published == 0  # the frame is still held


def test_two_stream_clients_do_not_double_the_frames(serve):
    srv, base = serve(_session(GatedSession))
    s = srv.session
    with urllib.request.urlopen(f"{base}/stream", timeout=TIMEOUT) as r1, \
            urllib.request.urlopen(f"{base}/stream", timeout=TIMEOUT) as r2:
        for k in range(1, 4):
            assert s.entered.acquire(timeout=TIMEOUT)
            s.gate.release()
            f1, f2 = _read_part(r1), _read_part(r2)
            assert f1 == f2 and f1[0] == k  # the same frame to both clients
        assert s.entered.acquire(timeout=TIMEOUT)  # the render thread waits again
        with srv.lock:
            assert s.frame == srv.frames_committed == srv.published == 3
            assert float(s.framebuffer.count.max()) == 3.0 * CFG.spp


def test_orbit_during_a_frame_is_never_committed(serve):
    srv, base = serve(_session(GatedSession))
    s = srv.session
    with urllib.request.urlopen(f"{base}/stream", timeout=TIMEOUT) as r:
        assert s.entered.acquire(timeout=TIMEOUT)  # frame from the old camera
        assert b"camera origin" in _ctl(base, "yaw=0.3")
        s.gate.release()
        assert s.entered.acquire(timeout=TIMEOUT)  # the next frame, new camera
        with srv.lock:
            assert srv.dropped == 1 and srv.published == 0
            assert s.frame == 0 and float(s.framebuffer.count.max()) == 0.0
        s.gate.release()
        seq, _ = _read_part(r)
        assert seq == 1
        with srv.lock:
            assert s.frame == srv.frames_committed == 1
            counts = s.framebuffer.count.numpy()
            mean = s.framebuffer.mean.numpy()
            camera = s.camera
    np.testing.assert_array_equal(counts, np.full((CFG.height, CFG.width), 1.0 * CFG.spp))
    # The committed frame is the new camera's first frame, nothing else.
    _, step = make_scene_step(s.scene, CFG)
    fb, _ = step(s.scene, camera, fb_mod.create(CFG.height, CFG.width, device=CPU), 3, 0)
    np.testing.assert_array_equal(mean, fb.mean.numpy())
