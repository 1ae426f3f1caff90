"""Viewer tests — the reference GUI's defining behaviors (SURVEY.md §2 C16):
one in-flight render with latest-wins coalescing (gui.rs:37-48), algorithm
switch resetting all settings (gui.rs:334-339), and the 2× screenshot
(gui.rs:319-328)."""

import json
import time
import urllib.request as rq

import numpy as np
import pytest

from fractal_tpu.cli import parse_options
from fractal_tpu.viewer import scene_from_dict, scene_to_dict, start
from fractal_tpu.config import Scene, RGB


def test_scene_json_roundtrip():
    s = Scene(algo="julia", width=64, height=48, julia_set=(-0.8, 0.156),
              primary_color=RGB(1, 2, 3))
    s2 = scene_from_dict(json.loads(json.dumps(scene_to_dict(s))))
    assert s2 == s


@pytest.fixture(scope="module")
def server():
    opts = parse_options(["64", "48", "-o", "/tmp/viewer_test_shot",
                          "--format", "png"])
    srv = start(opts, port=8791, open_browser=False, block=False)
    yield "http://127.0.0.1:8791"
    srv.shutdown()


def _get(base, p):
    r = rq.urlopen(base + p, timeout=60)
    return r.headers, r.read()


def _post(base, p, obj):
    req = rq.Request(base + p, json.dumps(obj).encode(), method="POST")
    return json.loads(rq.urlopen(req, timeout=30).read() or b"{}")


def test_render_and_coalescing(server):
    h, png = _get(server, "/image?gen=-1")
    # wait for the first render
    for _ in range(120):
        h, png = _get(server, "/image")
        if int(h["X-Gen"]) >= 1 and png[:4] == b"\x89PNG":
            break
        time.sleep(0.5)
    g0 = int(h["X-Gen"])
    assert png[:4] == b"\x89PNG"

    scene = json.loads(_get(server, "/scene")[1])
    # Make each render slower than the posting burst, else the worker keeps
    # up and no coalescing is needed (the reference behaves the same).
    scene["width"], scene["height"] = 512, 512
    scene["iterations"] = 2000
    _post(server, "/config", scene)
    time.sleep(0.1)
    g0 = int(_get(server, "/image")[0]["X-Gen"])
    for i in range(15):  # rapid-fire config changes
        scene["exposure"] = 5.0 + i * 0.01
        _post(server, "/config", scene)
    deadline = time.time() + 60
    while time.time() < deadline:
        time.sleep(1.0)
        h, _ = _get(server, "/image")
        # wait until the worker drains (last exposure rendered)
        if float(h["X-Render-Ms"]) > 0 and int(h["X-Gen"]) >= g0 + 1:
            break
    time.sleep(2.0)
    gend = int(_get(server, "/image")[0]["X-Gen"])
    assert 1 <= gend - g0 <= 5  # coalesced: nowhere near 15 renders
    # restore small dims for the remaining tests
    scene["width"], scene["height"], scene["iterations"] = 64, 48, 50
    _post(server, "/config", scene)


def test_algo_reset_keeps_dims(server):
    d = _post(server, "/reset", {"algo": "fern"})
    assert d["algo"] == "fern"
    assert d["iterations"] == 10_000_000  # Config::new(fern) default
    assert (d["width"], d["height"]) == (64, 48)
    assert d["secondary_color"] == [240, 240, 240]
    _post(server, "/reset", {"algo": "mandelbrot"})


def test_apply_nav_exact_pan_past_f64():
    """panning must survive past the f64 grid.  At depth
    a 40-pixel pan is ~4e-26 — far below f64 ulp at |x|~0.74 — yet the
    exact position must move and the rendered view must change."""
    from fractions import Fraction

    from fractal_tpu.config import exact_pos
    from fractal_tpu.render import render
    from fractal_tpu.viewer import apply_nav

    # the needle view of test_exact_string_center_beyond_f64: structure at
    # every scale, so a sub-f64 shift is visible
    scene = Scene(width=24, height=16, iterations=300,
                  pos_str=("-1.999999999999999999999999999",
                           "0.0000000000000000000000000035"),
                  scale=(1e26, 1e26))
    # pre-scale pan step of 40 pixels: du = px / height
    moved = apply_nav(scene, pan=(40.0 / 16.0, 0.0))
    e0, _ = exact_pos(scene)
    e1, _ = exact_pos(moved)
    assert e1 - e0 == Fraction(40, 16) / Fraction(1e26)
    # the f64 pos cannot represent the shift...
    assert float(e1) == float(e0)
    # ...but the render sees it
    a = render(scene)
    b = render(moved)
    assert (a != b).any(), "deep pan did not change the rendered view"
    # zoom multiplies scale only
    z = apply_nav(scene, zoom=2.0)
    assert z.scale == (2e26, 2e26) and z.pos_str == scene.pos_str


def test_nav_endpoint(server):
    scene = json.loads(_get(server, "/scene")[1])
    out = _post(server, "/nav", {"pan": [0.25, 0.0]})
    assert abs(out["pos"][0] - (scene["pos"][0] + 0.25 / scene["scale"][0])) < 1e-12
    assert out["pos_str"] is not None
    out2 = _post(server, "/nav", {"zoom": 2.0})
    assert abs(out2["scale"][0] - 2 * out["scale"][0]) < 1e-9


def _drain(server, g0, timeout=120.0):
    """Wait until the render generation passes g0 (no render left in
    flight — a worker busy at module teardown crashes the interpreter)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        h, png = _get(server, "/image")
        if int(h["X-Gen"]) > g0 and png[:4] == b"\x89PNG":
            return int(h["X-Gen"])
        time.sleep(0.5)
    raise AssertionError("viewer render did not finish")


def test_config_accepts_p32_fast_preview(server):
    scene = json.loads(_get(server, "/scene")[1])
    g0 = int(_get(server, "/image")[0]["X-Gen"])
    scene["precision"] = "p32"
    scene["scale"] = [1e6, 1e6]
    scene["pos"] = [-0.7436447860, 0.1318252536]
    _post(server, "/config", scene)
    out = json.loads(_get(server, "/scene")[1])
    assert out["precision"] == "p32"
    g1 = _drain(server, g0)          # the p32 render completed
    scene["precision"] = "auto"
    scene["scale"] = [0.4, 0.4]
    scene["pos"] = [-0.6, 0.0]
    _post(server, "/config", scene)
    _drain(server, g1)               # queue empty before module teardown


def test_config_accepts_power(server):
    """The z^d exponent control (r3): a julia power-3 config must
    round-trip through /config and render (the power field passes through
    scene_from_dict untouched)."""
    scene = json.loads(_get(server, "/scene")[1])
    g0 = int(_get(server, "/image")[0]["X-Gen"])
    scene["algo"] = "julia"
    scene["power"] = 3
    scene["julia_set"] = [0.44304637997136526, 0.558308536476846]
    scene["pos"] = [0.29278020065726197, 0.26384077469970184]
    scene["scale"] = [200.0, 200.0]
    _post(server, "/config", scene)
    out = json.loads(_get(server, "/scene")[1])
    assert out["power"] == 3 and out["algo"] == "julia"
    g1 = _drain(server, g0)          # the cubic julia render completed
    scene["algo"] = "mandelbrot"
    scene["power"] = 2
    scene["pos"] = [-0.6, 0.0]
    scene["scale"] = [0.4, 0.4]
    scene["julia_set"] = [-0.8, 0.156]
    _post(server, "/config", scene)
    _drain(server, g1)               # queue empty before module teardown


def test_pos_endpoint_exact_roundtrip_at_depth(server):
    """numeric pos/scale editing.  A typed 1e20×
    center must round-trip EXACTLY (the strings become pos_str, not f64)."""
    x = "-0.743643887037158704752191506114774"
    y = "0.131825904205311970493132056385139"
    out = _post(server, "/pos", {"x": x, "y": y, "scale": 1e20})
    assert out["pos_str"] == [x, y]
    assert out["scale"] == [1e20, 1e20]
    # the exact strings survive a GET /scene round trip
    again = json.loads(_get(server, "/scene")[1])
    assert again["pos_str"] == [x, y]
    # partial update: scale only, position untouched
    out2 = _post(server, "/pos", {"scale": 0.4})
    assert out2["scale"] == [0.4, 0.4] and out2["pos_str"] == [x, y]
    # julia c numeric edit
    out3 = _post(server, "/pos", {"julia": [-0.8, 0.156]})
    assert out3["julia_set"] == [-0.8, 0.156]
    # invalid strings are a clean 400, state unchanged
    import urllib.error

    req = rq.Request(server + "/pos",
                     json.dumps({"x": "not-a-number", "y": "0"}).encode(),
                     method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        rq.urlopen(req, timeout=30)
    assert ei.value.code == 400
    assert json.loads(_get(server, "/scene")[1])["pos_str"] == [x, y]
    # restore a cheap view and drain before teardown
    g0 = int(_get(server, "/image")[0]["X-Gen"])
    _post(server, "/pos", {"x": "-0.6", "y": "0.0", "scale": 0.4})
    _drain(server, g0)


def test_status_headers_tier_and_glitch(server):
    """the viewer must surface the resolved precision
    tier (and glitch counts at depth) per frame."""
    scene = json.loads(_get(server, "/scene")[1])
    g0 = int(_get(server, "/image")[0]["X-Gen"])
    scene.update(width=48, height=32, iterations=200, precision="auto",
                 pos=[-0.74364388703715871, 0.13182590420531198],
                 pos_str=None, scale=[1e15, 1e15])
    _post(server, "/config", scene)
    deadline = time.time() + 120
    while time.time() < deadline:
        h, png = _get(server, "/image")
        # earlier queued renders may land first: wait for THIS config's tier
        if (int(h["X-Gen"]) > g0 and png[:4] == b"\x89PNG"
                and h["X-Tier"] == "perturb"):
            break
        time.sleep(0.5)
    assert h["X-Tier"] == "perturb"
    assert h["X-Glitch"].isdigit()  # exact tier tracks the glitch count
    # active kernel route + last-frame device ms.  On the
    # CPU test backend every perturbation render routes the XLA twin
    # (possibly with a BLA table); a GPU shows "kernel".
    assert h["X-Route"].startswith("xla-twin")
    assert float(h["X-Device-Ms"]) > 0
    g1 = int(h["X-Gen"])
    # shallow view resolves to f32 and reports no glitch field content
    scene.update(scale=[0.4, 0.4], pos=[-0.6, 0.0], iterations=50)
    _post(server, "/config", scene)
    deadline = time.time() + 60
    while time.time() < deadline:
        h, png = _get(server, "/image")
        if (int(h["X-Gen"]) > g1 and png[:4] == b"\x89PNG"
                and h["X-Tier"] == "f32"):
            break
        time.sleep(0.5)
    assert h["X-Tier"] == "f32" and h["X-Glitch"] == ""


def test_viewer_renders_across_mesh():
    """-g + --devices: viewer frames render across the mesh when the tier
    has a sharded program — bit-identical to the single-device render
    (same PNG bytes) — and the X-Devices header feeds the status line."""
    import numpy as np

    opts = parse_options(["64", "48", "--devices", "2", "--precision",
                          "ds32", "-o", "/tmp/viewer_mesh_shot",
                          "--format", "png"])
    srv = start(opts, port=8792, open_browser=False, block=False)
    try:
        base = "http://127.0.0.1:8792"
        png = b""
        h = {}
        for _ in range(120):
            h, png = _get(base, "/image")
            if int(h.get("X-Gen", 0)) >= 1 and png[:4] == b"\x89PNG":
                break
            time.sleep(0.5)
        assert png[:4] == b"\x89PNG"
        assert h["X-Devices"] == "2"

        from fractal_tpu.render import render
        from fractal_tpu.viewer import _encode_png

        assert png == _encode_png(np.asarray(render(opts.scene)))
    finally:
        srv.shutdown()
