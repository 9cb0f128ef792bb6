"""Live viewer tests — the Gui layer behaviors over HTTP.

Covers: RenderWidget frame serving (gamma display transform), the
RenderStatisticsModel stats endpoint, settings changes restarting
accumulation via the sequence-number bump (Gui/Application.cpp:119-127),
MainWindowBase method switching (MainWindowBase.cpp:143-161), pause/resume
(RunningStatus), and the Mouse camera interactions
(util/Mouse.cpp:316-460).
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from oppositerenderer.config import RenderConfig, RenderMethod
from oppositerenderer.scene import make_cornell_small
from oppositerenderer.viewer import RenderService, make_server

CFG = dict(width=24, height=24, photons_per_iteration=1 << 10,
           photon_grid_resolution=8, gather_photon_budget=32,
           pt_max_segments_nee=3)


@pytest.fixture(scope="module")
def viewer():
    scene, cam = make_cornell_small()
    cfg = RenderConfig(render_method=RenderMethod.PATH_TRACING, **CFG)
    svc = RenderService(scene, cam, cfg, seed=3, preview_every=1)
    server = make_server(svc, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    svc.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield svc, base
    svc.stop()
    server.shutdown()
    server.server_close()


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:  # urllib raises on 4xx/5xx
        return e.code, e.read(), dict(e.headers)


def _wait_for(predicate, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.1)
    return False


def _stats(base):
    return json.loads(_get(base, "/stats")[1])


def test_page_and_frame(viewer):
    svc, base = viewer
    status, body, _ = _get(base, "/")
    assert status == 200 and b"opposite-renderer" in body

    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    status, png, headers = _get(base, "/frame.png")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    from oppositerenderer.png import decode_png
    img = decode_png(png)
    assert img.shape == (24, 24, 3)
    assert img.max() > 0  # the box is lit
    assert int(headers["X-Iteration"]) >= 1


def test_stats_fields(viewer):
    svc, base = viewer
    assert _wait_for(lambda: _stats(base)["iterations"] >= 2)
    s = _stats(base)
    assert s["render_method"] in ("pt", "ppm", "vcm")
    assert s["resolution"] == "24x24"
    assert s["scene"]
    assert s["running_status"] == "RUNNING"
    assert s["render_seconds"] > 0


def test_method_switch_restarts(viewer):
    svc, base = viewer
    assert _wait_for(lambda: _stats(base)["iterations"] >= 2)
    seq0 = _stats(base)["sequence_number"]
    _get(base, "/set?method=vcm")
    assert _wait_for(lambda: _stats(base)["render_method"] == "vcm")
    s = _stats(base)
    assert s["sequence_number"] == seq0 + 1
    # restart happened: the vcm film starts over
    assert _wait_for(lambda: 1 <= _stats(base)["iterations"])
    _get(base, "/set?method=pt")
    assert _wait_for(lambda: _stats(base)["render_method"] == "pt")


def test_camera_op_restarts_and_changes_view(viewer):
    svc, base = viewer
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    eye0 = np.asarray(svc.renderer.camera.eye).copy()
    status, _, _ = _get(base, "/camera?op=dolly&arg=0.3")
    assert status == 200
    assert _wait_for(
        lambda: not np.allclose(np.asarray(svc.renderer.camera.eye), eye0))
    # orbit keeps distance to lookat
    cam = svc.renderer.camera
    d0 = float(np.linalg.norm(np.asarray(cam.lookat) - np.asarray(cam.eye)))
    _get(base, "/camera?op=orbit&arg=0.5&arg=0.2")
    def orbited():
        c = svc.renderer.camera
        d = float(np.linalg.norm(np.asarray(c.lookat) - np.asarray(c.eye)))
        return (not np.allclose(np.asarray(c.eye),
                                np.asarray(cam.eye))) and \
            abs(d - d0) < 1e-3 * max(d0, 1.0)
    assert _wait_for(orbited)


def test_pause_resume(viewer):
    svc, base = viewer
    _get(base, "/control?cmd=pause")
    assert _wait_for(lambda: _stats(base)["running_status"] == "PAUSE")
    # one in-flight iteration may still land after the status flips (the
    # render thread checks the flag between iterations) — sample AFTER a
    # settle window, then require stability
    time.sleep(0.5)
    it = _stats(base)["iterations"]
    time.sleep(0.5)
    assert _stats(base)["iterations"] == it
    _get(base, "/control?cmd=resume")
    assert _wait_for(lambda: _stats(base)["iterations"] > it)


def test_gamma_changes_display_only(viewer):
    svc, base = viewer
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    seq0 = _stats(base)["sequence_number"]
    png1 = _get(base, "/frame.png")[1]
    _get(base, "/set?gamma=1.0")
    png2 = _get(base, "/frame.png")[1]
    assert _stats(base)["sequence_number"] == seq0  # no restart
    assert png1 != png2                             # but display changed
    _get(base, "/set?gamma=2.2")


def test_unknown_routes(viewer):
    svc, base = viewer
    assert _get(base, "/nope")[0] == 404
    assert _get(base, "/control?cmd=bogus")[0] == 400


def test_bad_camera_op_is_http_error_and_loop_survives(viewer):
    svc, base = viewer
    # invalid op / missing args are rejected at the handler (500), never
    # enqueued — the render loop must keep iterating afterwards
    assert _get(base, "/camera?op=bogus")[0] == 500
    assert _get(base, "/camera?op=orbit&arg=0.1")[0] == 500  # arity 2
    it = _stats(base)["iterations"]
    assert _wait_for(lambda: _stats(base)["iterations"] > it)


def test_scene_switch(viewer):
    svc, base = viewer
    seq0 = _stats(base)["sequence_number"]
    status, _, _ = _get(base, "/set?scene=Cornell")
    assert status == 200
    assert _wait_for(lambda: _stats(base)["scene"] == "Cornell"
                     and _stats(base)["sequence_number"] > seq0)
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)
    # loop survives a bad scene name too (error surfaces in stats)
    _get(base, "/set?scene=NoSuchScene")
    assert _wait_for(lambda: "last_error" in _stats(base))
    assert _wait_for(lambda: _stats(base)["iterations"] >= 1)


def test_workers_endpoint(viewer):
    svc, base = viewer
    # no farm attached: empty list
    assert json.loads(_get(base, "/workers")[1]) == []
    from oppositerenderer.parallel.distributed import IterationScheduler
    sched = IterationScheduler(total_iterations=8, packet_size=2)
    seq, its = sched.acquire("w0")
    sched.complete(seq, its)
    seq, its2 = sched.acquire("w1")
    svc.farm_stats = sched.worker_stats
    rows = json.loads(_get(base, "/workers")[1])
    by = {r["worker"]: r for r in rows}
    assert by["w0"]["iterations"] == 2 and by["w0"]["packets"] == 1
    assert by["w1"]["pending"] == 2
    svc.farm_stats = None
