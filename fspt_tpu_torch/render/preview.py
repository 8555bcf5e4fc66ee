"""Live progressive preview: a small localhost viewer.

Port of fspt_tpu/render/preview.py, the browser stand-in for the
reference's OpenGL window (reference main.cpp:114-165,
base_graphics.cpp:30-102): it serves a multipart ``x-mixed-replace`` PNG
stream from a :class:`~fspt_tpu_torch.interactive.RenderSession` and maps
the reference's interactions onto HTTP —

* arrow keys / a,d,w,s  → orbit (main.cpp:127-143's left-drag)
* click on the image    → focus at that pixel (main.cpp:144-154
  right-click → TraceRange → focal_depth)
* shift held            → fast-render 1-bounce preview (main.cpp:124)

Threading.  One render thread advances the session while at least one
``/stream`` client is connected, and publishes each committed frame as a
PNG with a sequence number; stream clients only wait for the next
published frame, so every client sees the same frames and the session
advances once per frame however many watch.  ``lock`` guards the
session's state only: the render thread takes the camera, framebuffer and
frame index under it, renders outside it, and commits under it only if no
interaction reset the session meanwhile (``RenderSession.generation``); a
frame rendered for a stale camera is dropped.  ``/ctl`` therefore waits
for the lock, not for the frame in flight.

    python -m fspt_tpu_torch.render.preview <scene-file> [--port 8787]

then open http://127.0.0.1:8787/ .
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

PAGE = b"""<!doctype html>
<html><head><title>fspt preview</title><style>
 body { background:#111; color:#ccc; font-family:monospace; text-align:center }
 img { image-rendering:pixelated; width:70vw; margin-top:2vh; cursor:crosshair }
</style></head><body>
<div>orbit: a/d/w/s or arrows &middot; click: focus &middot;
 shift: fast preview</div>
<img id=v src="/stream">
<div id=s></div>
<script>
const v = document.getElementById('v'), s = document.getElementById('s');
function send(q) { fetch('/ctl?' + q).then(r => r.text()).then(t => s.textContent = t); }
document.addEventListener('keydown', e => {
  const k = {a:'yaw=-0.1', ArrowLeft:'yaw=-0.1', d:'yaw=0.1',
             ArrowRight:'yaw=0.1', w:'pitch=0.1', ArrowUp:'pitch=0.1',
             s:'pitch=-0.1', ArrowDown:'pitch=-0.1'}[e.key];
  if (k) send(k);
  if (e.key === 'Shift') send('fast=1');
});
document.addEventListener('keyup', e => {
  if (e.key === 'Shift') send('fast=0');
});
v.addEventListener('click', e => {
  const r = v.getBoundingClientRect();
  const x = Math.floor((e.clientX - r.left) / r.width * %W%);
  const y = Math.floor((1 - (e.clientY - r.top) / r.height) * %H%);
  send('focus_x=' + x + '&focus_y=' + y);
});
</script></body></html>"""

BOUNDARY = b"fsptframe"


class PreviewServer:
    """Serve a RenderSession as a live auto-refining browser view.

    ``published`` counts the frames published, ``frames_committed`` the
    session frames committed in all and ``dropped`` the renders discarded
    because an interaction reset the session while they ran.
    """

    def __init__(self, session, host: str = "127.0.0.1", port: int = 8787,
                 frames_per_update: int = 1):
        self.session = session
        self.lock = threading.Lock()  # the session's state
        self.frames_per_update = frames_per_update
        self.published = 0
        self.frames_committed = 0
        self.dropped = 0
        self.error = None
        self._png = None
        self._viewers = 0
        self._stopping = False
        self._cv = threading.Condition()  # the published frame, viewers, stop
        self._render_thread = threading.Thread(target=self._render_loop, daemon=True,
                                               name="preview-render")
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    page = PAGE.replace(
                        b"%W%", str(outer.session.cfg.width).encode()
                    ).replace(b"%H%", str(outer.session.cfg.height).encode())
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(page)
                elif u.path == "/ctl":
                    msg = outer.control(parse_qs(u.query))
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.end_headers()
                    self.wfile.write(msg.encode())
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=" + BOUNDARY.decode())
                    self.end_headers()
                    outer._watch(1)
                    try:
                        seq = 0
                        while True:
                            frame = outer.next_frame(seq)
                            if frame is None:
                                return
                            seq, png = frame
                            self.wfile.write(
                                b"--" + BOUNDARY + b"\r\n"
                                b"Content-Type: image/png\r\n"
                                b"X-Frame: " + str(seq).encode() + b"\r\n"
                                b"Content-Length: " + str(len(png)).encode() + b"\r\n\r\n"
                                + png + b"\r\n")
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return
                    finally:
                        outer._watch(-1)
                else:
                    self.send_response(404)
                    self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = host, self.httpd.server_address[1]
        self._render_thread.start()

    # -- interaction (reference main.cpp:117-154) ---------------------------

    def control(self, q) -> str:
        g = lambda k: float(q[k][0]) if k in q else None
        with self.lock:
            s = self.session
            if g("yaw") is not None or g("pitch") is not None:
                s.orbit(g("yaw") or 0.0, g("pitch") or 0.0)
                o = s.camera.origin.tolist()
                return f"camera origin ({o[0]:.1f}, {o[1]:.1f}, {o[2]:.1f})"
            if g("focus_x") is not None:
                d = s.focus_at(int(g("focus_x")), int(g("focus_y") or 0))
                return f"Setting focus distance to {d:.2f}"  # main.cpp:151
            if g("fast") is not None:
                s.set_fast_render(bool(int(g("fast"))))
                return f"fast_render={bool(int(g('fast')))}"
        return "ok"

    # -- frames -------------------------------------------------------------

    def _watch(self, delta: int):
        with self._cv:
            self._viewers += delta
            self._cv.notify_all()

    def next_frame(self, after: int = 0):
        """``(seq, png)`` of the latest published frame once its sequence
        number passes ``after`` (waiting for that), or None once the server
        stops."""
        with self._cv:
            while self.published <= after and not self._stopping and self.error is None:
                self._cv.wait()
            if self.error is not None:
                raise RuntimeError("the preview's render thread failed") from self.error
            if self._stopping:
                return None
            return self.published, self._png

    def _render_loop(self):
        from fspt_tpu_torch.utils.image import png_bytes

        s, n = self.session, self.frames_per_update
        try:
            while True:
                with self._cv:
                    while self._viewers == 0 and not self._stopping:
                        self._cv.wait()
                    if self._stopping:
                        return
                with self.lock:
                    camera, fb, frame = s.camera, s.framebuffer, s.frame
                    fast, generation = s.fast_render, s.generation
                fb, _ = s._render(camera, fb, frame, n, fast)
                with self.lock:
                    fresh = s._commit(fb, frame, n, generation)
                    if fresh:
                        self.frames_committed += n
                    else:
                        self.dropped += 1
                if fresh:
                    # Row 0 is the bottom scanline (camera up = +Y): flip.
                    png = png_bytes(s._display(fb)[::-1])
                    with self._cv:
                        self._png = png
                        self.published += 1
                        self._cv.notify_all()
        except BaseException as exc:
            with self._cv:
                self.error = exc
                self._cv.notify_all()
            raise

    def serve_forever(self):
        print(f"preview at http://{self.host}:{self.port}/ "
              f"(path: {self.session.path_name or 'pending first frame'})")
        self.httpd.serve_forever()

    def shutdown(self):
        """Stop serving; the render thread ends after its frame in flight."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._render_thread.join()


def main(argv=None):
    import argparse
    import sys

    p = argparse.ArgumentParser()
    p.add_argument("file")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--width", type=int, default=400)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    from fspt_tpu_torch.config import RenderConfig, resolve_device
    from fspt_tpu_torch.interactive import RenderSession
    from fspt_tpu_torch.scene.parser import load_scene

    device = resolve_device(args.device)
    session = RenderSession(
        load_scene(args.file, device=device),
        RenderConfig(width=args.width, height=args.height, spp=args.spp), device=device)
    PreviewServer(session, port=args.port).serve_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
