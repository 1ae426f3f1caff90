"""CLI parity tests: every invocation from the reference's examples.md must
parse to the correct Scene (src/lib.rs:31-234 flag surface)."""

import pytest

from fractal_tpu.cli import parse_options
from fractal_tpu.config import RGB


def test_defaults_no_arguments():  # "Golden" example
    o = parse_options([])
    s = o.scene
    assert (s.width, s.height) == (750, 500)
    assert s.algo == "mandelbrot"
    assert s.iterations == 50
    assert s.limit == 65536.0
    assert s.stable_limit == 2.0
    assert s.pos == (-0.6, 0.0)           # CLI default -x −0.6
    assert s.scale == (0.4, 0.4)
    assert s.exposure == 5.0              # CLI tier overrides Config's 2.0
    assert s.inside and s.smooth
    assert o.filename == "output" and not o.open and not o.gui


def test_julia_pos_x_defaults_to_zero():
    # clap default_value_if("algo", "julia", "0") — src/lib.rs:69-71
    o = parse_options("-a julia --julia-real -0.8 --julia-imaginary 0.156".split())
    assert o.scene.pos == (0.0, 0.0)
    assert o.scene.julia_set == (-0.8, 0.156)
    # explicit -x still wins
    o2 = parse_options(
        "-a julia --julia-real -0.2256 --julia-imaginary 0.65 "
        "-x 0.29449 -y -0.40460".split()
    )
    assert o2.scene.pos == (0.29449, -0.4046)


def test_julia_requires_c():
    with pytest.raises(SystemExit):
        parse_options(["-a", "julia"])


def test_examples_md_recipes():
    # "-a julia --julia-real -0.8 --julia-imaginary 0.156 -i 2000 -s 0.6
    #  -e 30 2000 1000"
    o = parse_options(
        "-a julia --julia-real -0.8 --julia-imaginary 0.156 -i 2000 "
        "-s 0.6 -e 30 2000 1000".split()
    )
    s = o.scene
    assert (s.width, s.height) == (2000, 1000)
    assert s.iterations == 2000 and s.exposure == 30.0
    assert s.scale == (0.6, 0.6)

    # classic: "-d 3000 2000"
    o = parse_options("-d 3000 2000".split())
    assert not o.scene.inside
    assert (o.scene.width, o.scene.height) == (3000, 2000)

    # deepest zoom recipe (examples.md:29)
    o = parse_options(
        "-s 500000 -x -.7436447860 -y .1318252536 -i 4000 -d -e 5 "
        "4000 2000".split()
    )
    s = o.scene
    assert s.scale == (500000.0, 500000.0)
    assert s.pos == (-0.7436447860, 0.1318252536)
    assert s.iterations == 4000 and not s.inside

    # fern: "-a fern 1000 1000"
    o = parse_options("-a fern 1000 1000".split())
    assert o.scene.algo == "fern"
    assert o.scene.iterations == 10_000_000
    assert o.scene.primary_color == RGB(4, 3, 100)


def test_scale_group_conflicts():
    with pytest.raises(SystemExit):
        parse_options("--scale-x 2 --scale-y 3".split())
    with pytest.raises(SystemExit):
        parse_options("-s 2 --scale-x 3".split())
    o = parse_options("--scale-x 2".split())
    assert o.scene.scale == (2.0, 0.4)    # other axis falls back to -s default
    o = parse_options("--scale-y 7".split())
    assert o.scene.scale == (0.4, 7.0)


def test_hex_colors_compat_swap():
    # Escape scenes always store the reference's swapped fields (the
    # render-time swap in color_multiply cancels it, so hex renders true);
    # --true-colors is a no-op there.
    o = parse_options("--primary-color 102030".split())
    assert o.scene.primary_color == RGB(0x10, 0x30, 0x20)
    o = parse_options("--primary-color 102030 --true-colors".split())
    assert o.scene.primary_color == RGB(0x10, 0x30, 0x20)
    # The fern has no cancelling second swap: --true-colors de-swaps storage.
    o = parse_options("-a fern --primary-color 102030".split())
    assert o.scene.primary_color == RGB(0x10, 0x30, 0x20)
    o = parse_options("-a fern --primary-color 102030 --true-colors".split())
    assert o.scene.primary_color == RGB(0x10, 0x20, 0x30)


def test_escape_hex_color_renders_true():
    """End-to-end: a hex primary must land in the image un-swapped (the
    reference's parse-time and render-time swaps cancel)."""
    import numpy as np
    from fractal_tpu.render import render

    o = parse_options(
        "--primary-color ff0080 -d -i 30 -e 1000 --precision f64 24 16".split())
    img = np.asarray(render(o.scene, backend="jnp"))
    esc = img[(img != 0).any(-1)]  # -d: every lit pixel is an escape pixel
    assert esc.size and (esc[:, 1] == 0).all() and (esc[:, 2] > 0).any()


def test_output_suffix_rule():
    from fractal_tpu.io.image_out import output_filename

    # src/lib.rs:192-195: suffix appended unconditionally
    assert output_filename("output") == "output.avif"
    assert output_filename("a.avif") == "a.avif.avif"
    assert output_filename("x", "png") == "x.png"


def test_extensions_parse():
    o = parse_options(
        "-a multibrot --power 5 --supersample 2 --precision f32 "
        "--format png --seed 3".split()
    )
    s = o.scene
    assert s.algo == "multibrot" and s.power == 5
    assert s.supersample == 2 and s.precision == "f32" and s.seed == 3
    assert o.fmt == "png"


def test_end_to_end_main_writes_png(tmp_path):
    from fractal_tpu.__main__ import main

    out = tmp_path / "img"
    rc = main(["32", "24", "-i", "20", "--format", "png", "-o", str(out)])
    assert rc == 0
    assert (tmp_path / "img.png").exists()
    from PIL import Image

    im = Image.open(tmp_path / "img.png")
    assert im.size == (32, 24)


def test_main_render_error_exits_cleanly():
    """Render-time ValueErrors surface as a one-line `error: ...` exit (the
    reference binary's failure style), not a traceback."""
    import pytest
    from fractal_tpu.__main__ import main

    with pytest.raises(SystemExit) as ei:
        main("16 12 --precision p32 -a julia --power 1 --julia-real -0.8 "
             "--julia-imaginary 0.156 --format png -o /tmp/never".split())
    assert str(ei.value).startswith("error: perturbation supports")


def test_perturb_rejects_unsupported_rule():
    """A sub-quadratic power has no delta-recurrence (z^1 + c is affine —
    not an escape-time fractal; powers >= 2 are all covered since r3):
    must raise, not silently render garbage."""
    import pytest
    from fractal_tpu.config import Scene
    from fractal_tpu.render import render_u8

    scene = Scene(algo="julia", power=1, julia_set=(-0.8, 0.156),
                  width=16, height=12, iterations=20, precision="perturb")
    with pytest.raises(ValueError, match="perturbation supports"):
        render_u8(scene)


def test_devices_flag_sharded_still_bit_identical(tmp_path):
    """--devices N routes a still render through the mesh (SURVEY §2 C7) and must be bit-identical to the single-device render; fern
    routes the psum ensemble (C9)."""
    import numpy as np
    from PIL import Image

    from fractal_tpu.__main__ import main

    a, b = tmp_path / "one", tmp_path / "mesh"
    # pin the tier: CPU auto resolves f64 single-device, the mesh kernels
    # are the f32/ds32 pair — bit-equality is contracted per precision
    args = ["48", "32", "-i", "30", "--format", "png", "--precision", "ds32"]
    assert main(args + ["-o", str(a)]) == 0
    assert main(args + ["-o", str(b), "--devices", "4"]) == 0
    ia = np.asarray(Image.open(f"{a}.png"))
    ib = np.asarray(Image.open(f"{b}.png"))
    np.testing.assert_array_equal(ia, ib)

    f = tmp_path / "fern"
    rc = main(["32", "32", "-a", "fern", "-i", "20000", "--format", "png",
               "-o", str(f), "--devices", "0"])  # 0 = all (8 virtual)
    assert rc == 0
    imf = np.asarray(Image.open(f"{f}.png"))
    assert tuple(imf[0, 0]) == (240, 240, 240)  # background survives psum


def test_devices_flag_validation_and_mode_composition():
    import pytest

    from fractal_tpu.cli import parse_options

    with pytest.raises(SystemExit):
        parse_options(["32", "24", "--devices", "-2"])
    # --devices composes with every mode since r4: stills, --animate
    # (frame-parallel sweeps), --bands (row-interleaved bands), -g (viewer)
    opts = parse_options(["32", "24", "--devices", "2",
                          "--animate", "4", "--sweep", "zoom"])
    assert opts.devices == 2 and opts.animate == 4
    opts = parse_options(["32", "24", "--devices", "2", "--bands", "16"])
    assert opts.devices == 2 and opts.bands == 16
    opts = parse_options(["32", "24", "--devices", "2", "-g"])
    assert opts.devices == 2 and opts.gui


def test_devices_flag_errors_when_too_few(tmp_path):
    import pytest

    from fractal_tpu.__main__ import main

    with pytest.raises(SystemExit, match="device"):
        main(["16", "12", "--devices", "64", "--format", "png",
              "-o", str(tmp_path / "x")])
