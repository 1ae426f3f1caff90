"""Smoke run of the renderer on one GPU, end to end.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the mesh phase only

Phases, each timed; any failure ends the run with a non-zero exit:

  identity  the card's name and power limit (nvidia-smi) and JAX's view;
  build     the native orbit walker, from the checkout;
  cli       the repo's full-size scenes through ``python -m fractal_tpu``'s
            entry point, in this process: compile wall and warm wall of
            each, the PNG read back and checked;
  parity    every hand-written kernel against its plain reference at full
            width, each measured value printed beside its tolerance;
  timing    each kernel's full render program against its XLA twin's:
            compile wall and warm p50 of 3 runs;
  mesh      (--devices 4 only) the sharded paths against the single-card
            render on card 0, with every output spread over all 4 cards.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU the script exits non-zero before any phase and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# The repo's full-size scenes (bench.py's headline and configs) as CLI
# argument lists.
HEADLINE = ["3000", "3000", "-s", "1000000", "-x", "-.7436447860",
            "-y", ".1318252536", "-i", "4000", "-d", "-e", "5"]
CLI_SCENES = {
    "headline_p32": HEADLINE + ["--precision", "p32"],
    "headline_auto": HEADLINE,
    "julia_1080p": ["1920", "1080", "-a", "julia", "--julia-real", "-0.8",
                    "--julia-imaginary", "0.156", "-i", "300", "-s", "0.4",
                    "-x", "0", "-y", "0"],
    "perturb_1e12": ["3000", "3000", "-s", "1e12",
                     "-x", "-0.74364388703715871",
                     "-y", "0.13182590420531198", "-i", "4000", "-d"],
    "floatexp_1e44": ["768", "512", "-s", "1e44",
                      "-x", "-1.99999999999999999999999999999999999999999999"
                            "91", "-y", "0.0", "-i", "2000", "-d"],
    "fern_10m": ["750", "500", "-a", "fern", "-i", "10000000"],
}

# Tolerances of the parity phase.  Reasons:
#  * two compilations of the same f32 program (the kernel by Triton, the
#    twin by XLA) contract mul+add into FMAs differently, and a one-ulp
#    difference on a chaotic boundary pixel grows until its escape step
#    moves.  How many pixels that touches is a property of the view (1.3 %
#    of the julia frame, first run on the card), so the f32 kernel is held
#    to the f64 oracle instead: it may disagree with f64 on at most half a
#    percent of the frame more than the same program compiled for the CPU.
#  * f64 too: at the headline's 4000 iterations, f64 itself disagrees with
#    double-double on 1.7 % of a central strip (second run on the card; a
#    1e-3 tolerance on the raw kernel-vs-CPU mismatch failed at 1.66 %), so
#    the f64 kernel is held to the dd64 oracle the same way.
#  * ds32 step: its error against f64 is an absolute ~2^-48 of the
#    largest term — 7.6·2^-48 at most over the test inputs on the CPU (a
#    4·2^-48 tolerance, set before the third run on the card, was below
#    what the algorithm itself gives).  Triton contracts some of
#    quad_step's mul+add pairs into FMAs (42 % of its results differ from
#    the CPU's in the last bits, fourth run), so what must hold is the
#    error bound, not bit equality with the CPU.
#  * f32 δ-orbits: counts of chaotic pixels differ between the kernel and
#    the twin for the FMA reason above; what must hold is the fast tier's
#    documented envelope, ≥ 99.9 % interior/escaped classification, between
#    the two programs and against the exact tier.
TOL = {
    "k1_f32_vs_f64_excess_mismatch": 5e-3,
    "k1_f64_vs_dd64_excess_mismatch": 5e-3,
    "k1_ds32_step_err_2^-48": 16.0,
    "k1_ds32_vs_f64_count_mismatch": 5e-2,
    "k2_classification_agreement": 0.999,
    "k2_glitch_flag_mismatch": 1e-2,
    "p32_classification_agreement": 0.999,
    "bship_pinned_count_mismatch": 0.0,
    # the mesh renders run the single-card programs: bit-identical, except
    # that the exact tier's glitched pixels may be resolved against other
    # secondary references (each exact, rounded differently)
    "mesh_pixel_mismatch": 0.0,
    "mesh_perturb_pixel_mismatch": 1e-4,
}


def _log(msg: str) -> None:
    print(msg, flush=True)


class Phases:
    """Times named phases; a phase that raises ends the run."""

    def __init__(self):
        self.walls = {}

    def run(self, name, fn, *args, **kwargs):
        _log(f"== {name}")
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.walls[name] = time.perf_counter() - t0
        _log(f"== {name}: {self.walls[name]:.1f} s")
        return out


def check(name: str, value: float, tol: float, higher_is_better=False):
    """Print a parity value beside its tolerance; raise past it."""
    ok = value >= tol if higher_is_better else value <= tol
    rel = ">=" if higher_is_better else "<="
    _log(f"  parity {name}: {value:.6g} (tolerance {rel} {tol:g}) "
         f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"parity {name}: {value} vs tolerance {tol}")


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 from an 8-bit RGB PNG whose rows all use filter 0
    (what fractal_tpu.io.image_out.png_bytes writes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not 8-bit RGB")
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters this reader lacks")
    return raw[:, 1:].reshape(h, w, 3)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def identity():
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        _log(f"card: {line.strip()}")
    d = jax.devices()[0]
    _log(f"jax: platform={d.platform} kind={d.device_kind} "
         f"count={len(jax.devices())} jax={jax.__version__}")


def build():
    subprocess.run(["make", "-C", os.path.join(HERE, "native"),
                    "liborbitwalk.so"], check=True)
    from fractal_tpu.ops import native_walk

    if not native_walk.available():
        raise RuntimeError("native orbit walker did not load after build")


def cli_renders(out_dir: str):
    """Each scene of CLI_SCENES twice through the CLI entry point (cold,
    then warm), its PNG read back and checked."""
    from fractal_tpu.__main__ import main
    from fractal_tpu.cli import parse_options
    from fractal_tpu.ops.perturb import RENDER_STATS
    from fractal_tpu.render import resolve_precision

    walls = {}
    for name, argv in CLI_SCENES.items():
        argv = argv + ["--format", "png", "-o", os.path.join(out_dir, name)]
        t = []
        for _ in range(2):
            t0 = time.perf_counter()
            # main() fetches the image to the host and writes the PNG
            # before it returns, so the wall covers the whole render
            if main(argv) != 0:
                raise RuntimeError(f"{name}: CLI exited non-zero")
            t.append(time.perf_counter() - t0)
        scene = parse_options(argv).scene
        img = read_png(os.path.join(out_dir, name) + ".png")
        if img.shape != (scene.height, scene.width, 3):
            raise AssertionError(f"{name}: PNG shape {img.shape}")
        if len(np.unique(img.reshape(-1, 3), axis=0)) < 8:
            raise AssertionError(f"{name}: image is not structured")
        extra = ""
        if scene.algo == "fern":
            if tuple(img[0, 0]) != (240, 240, 240):
                raise AssertionError(f"{name}: fern corner {img[0, 0]}")
        else:
            prec = resolve_precision(scene)
            extra = f" precision={prec}"
            if name == "headline_auto" and prec != "f64":
                raise AssertionError(f"auto resolved to {prec}, not f64")
            if prec == "perturb":
                nres = int(RENDER_STATS.get("n_residual") or 0)
                extra += (f" tier={RENDER_STATS['tier']}"
                          f" route={RENDER_STATS['route']}"
                          f" n_glitch={RENDER_STATS['n_glitch']}"
                          f" n_residual={nres}")
                if nres != 0:
                    raise AssertionError(f"{name}: {nres} residual pixels")
        walls[name] = t
        _log(f"  cli {name}: compile wall {t[0]:.2f} s, warm wall "
             f"{t[1]:.2f} s{extra}")
    return walls


def _strip_params(scene, dtype, start: int):
    from fractal_tpu.ops.escape_pallas import scene_params

    return scene_params(scene, dtype=dtype).at[15].set(float(start))


def _counts(scene, params, precision, impl, rows, device=None):
    import jax

    from fractal_tpu.ops.escape_pallas import iterate_params

    def f(p):
        return iterate_params(
            p, algo=scene.algo, power=scene.power,
            iterations=scene.iterations, precision=precision, height=rows,
            width=scene.width, impl=impl, periodicity=not scene.inside)[2]

    if device is not None:
        params = jax.device_put(params, device)
    return np.asarray(jax.jit(f)(params))


def parity():
    import jax
    import jax.numpy as jnp

    from fractal_tpu.config import Scene
    from fractal_tpu.ops import perturb as pt

    cpu = jax.devices("cpu")[0]
    head = Scene(width=3000, height=3000, iterations=4000,
                 pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                 exposure=5.0, inside=False)
    julia = Scene(algo="julia", width=1920, height=1080, iterations=300,
                  julia_set=(-0.8, 0.156), scale=(0.4, 0.4), pos=(0.0, 0.0))

    # K1 f32: the whole julia 1080p frame, kernel on the card vs the same
    # program (the XLA twin) on the host CPU, and both vs the f64 oracle
    p = _strip_params(julia, jnp.float32, 0)
    a = _counts(julia, p, "f32", "triton", julia.height)
    b = _counts(julia, p, "f32", "xla", julia.height, device=cpu)
    o = _counts(julia, _strip_params(julia, jnp.float64, 0), "f64", "xla",
                julia.height, device=cpu)
    _log(f"  k1 f32 kernel vs cpu twin: count mismatch "
         f"{float((a != b).mean()):.6g}, largest count difference "
         f"{int(np.abs(a - b).max())}")
    gpu_off, cpu_off = float((a != o).mean()), float((b != o).mean())
    _log(f"  k1 f32 vs f64 oracle: kernel {gpu_off:.6g}, cpu twin "
         f"{cpu_off:.6g}")
    check("k1_f32_vs_f64_excess_mismatch", gpu_off - cpu_off,
          TOL["k1_f32_vs_f64_excess_mismatch"])

    # K1 f64: a full-width 32-row strip through the headline's centre,
    # kernel vs the same program on the CPU, both vs the dd64 oracle
    strip = 32
    p64 = _strip_params(head, jnp.float64, 1484)
    a = _counts(head, p64, "f64", "triton", strip)
    b = _counts(head, p64, "f64", "xla", strip, device=cpu)
    o = _counts(head, p64, "dd64", "xla", strip, device=cpu)
    _log(f"  k1 f64 kernel vs cpu twin: count mismatch "
         f"{float((a != b).mean()):.6g}, largest count difference "
         f"{int(np.abs(a - b).max())}")
    gpu_off, cpu_off = float((a != o).mean()), float((b != o).mean())
    _log(f"  k1 f64 vs dd64 oracle: kernel {gpu_off:.6g}, cpu twin "
         f"{cpu_off:.6g}")
    check("k1_f64_vs_dd64_excess_mismatch", gpu_off - cpu_off,
          TOL["k1_f64_vs_dd64_excess_mismatch"])

    # K1 ds32: one double-single step in a Triton kernel against the same
    # step on the CPU, and against f64
    mismatch, err = _ds32_step_error()
    _log(f"  k1 ds32 step results differing from the CPU's: {mismatch:.6g}")
    check("k1_ds32_step_err_2^-48", err, TOL["k1_ds32_step_err_2^-48"])
    # ... and the whole headline's counts against the f64 kernel
    full64 = _counts(head, _strip_params(head, jnp.float64, 0), "f64",
                     "triton", head.height)
    ds = _counts(head, _strip_params(head, jnp.float32, 0), "ds32", "triton",
                 head.height)
    check("k1_ds32_vs_f64_count_mismatch", float((ds != full64).mean()),
          TOL["k1_ds32_vs_f64_count_mismatch"])

    # K2 at the p32 headline: kernel vs the XLA twin on the card, and the
    # fast tier's interior/escaped classification vs the exact (f64) tier
    sc = head.replace(precision="p32")
    ref, orbit = pt.resolve_reference(sc, 3000, 3000)
    P = pt._pert_params(sc, ref, 3000, 3000, orbit=orbit)
    ns = jnp.int32(orbit.n_steps)
    packed = pt._packed_for(sc, orbit, ref, 3000, 3000, True)
    _, kc = pt.perturb_kernel(packed, P, ns, iterations=4000, height=3000,
                              width=3000, glitch=False, dist_only=True)
    kc = np.asarray(kc)
    tc = np.asarray(pt._render_perturb_jit(
        sc, packed, P, ns, height=3000, width=3000, chunk=pt.PERT_CHUNK)[4])
    _log(f"  k2 p32 headline kernel vs twin: count mismatch "
         f"{float((kc != tc).mean()):.6g}")
    check("k2_classification_agreement (p32 headline)",
          float(((kc < 4000) == (tc < 4000)).mean()),
          TOL["k2_classification_agreement"], higher_is_better=True)
    agree = float(((kc < 4000) == (full64 < 4000)).mean())
    check("p32_classification_agreement", agree,
          TOL["p32_classification_agreement"], higher_is_better=True)

    # K2 with glitch detection at 1e12 (the exact tier's main grid)
    deep = head.replace(scale=(1e12, 1e12),
                        pos=(-0.74364388703715871, 0.13182590420531198))
    ref, orbit = pt.resolve_reference(deep, 3000, 3000)
    P = pt._pert_params(deep, ref, 3000, 3000, orbit=orbit)
    ns = jnp.int32(orbit.n_steps)
    packed = pt._packed_for(deep, orbit, ref, 3000, 3000, False)
    k = [np.asarray(x) for x in pt.perturb_kernel(
        packed, P, ns, iterations=4000, height=3000, width=3000)]
    t = [np.asarray(x) for x in pt._render_perturb_jit(
        deep, packed, P, ns, height=3000, width=3000,
        chunk=pt.PERT_CHUNK)[2:]]
    _log(f"  k2 1e12 kernel vs twin: count mismatch "
         f"{float((k[2] != t[2]).mean()):.6g}")
    check("k2_classification_agreement (1e12)",
          float(((k[2] < 4000) == (t[2] < 4000)).mean()),
          TOL["k2_classification_agreement"], higher_is_better=True)
    check("k2_glitch_flag_mismatch (1e12)", float((k[3] != t[3]).mean()),
          TOL["k2_glitch_flag_mismatch"])

    # Burning ship: the traced-1.0 pins keep kernel and twin bit-identical
    bs = Scene(algo="burningship", width=512, height=384, iterations=1500,
               pos_str=("-0.45", "-0.829977217668251374661143257379"),
               scale=(1e14, 1e14), precision="perturb")
    ref, orbit = pt.resolve_reference(bs, 512, 384)
    P = pt._pert_params(bs, ref, 512, 384, orbit=orbit)
    ns = jnp.int32(orbit.n_steps)
    packed = jnp.asarray(orbit.packed)
    k = np.asarray(pt.perturb_kernel(packed, P, ns, iterations=1500,
                                     height=384, width=512,
                                     algo="burningship")[2])
    t = np.asarray(pt.perturb_whole_jnp(packed, P, ns, iterations=1500,
                                        height=384, width=512,
                                        chunk=pt.PERT_CHUNK,
                                        algo="burningship")[2])
    check("bship_pinned_count_mismatch", float((k != t).mean()),
          TOL["bship_pinned_count_mismatch"])


def _ds32_step_error():
    """One ds32 z² + c step compiled by Triton: (fraction of results that
    differ from the same step compiled for the CPU, largest error against
    f64 in units of 2^-48 of the step's largest term)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    from fractal_tpu.ops import dd

    n = 1 << 16
    rng = np.random.default_rng(0)
    z = rng.uniform(-2.0, 2.0, (4, n))
    hi = z.astype(np.float32)
    lo = (z - hi.astype(np.float64)).astype(np.float32)
    z = hi.astype(np.float64) + lo.astype(np.float64)

    def kernel(h_ref, l_ref, o_ref):
        zr, zi, cr, ci = ((h_ref[i, :], l_ref[i, :]) for i in range(4))
        (rh, rl), (ih, il) = dd.quad_step(zr, zi, cr, ci)
        o_ref[0, :] = rh
        o_ref[1, :] = rl
        o_ref[2, :] = ih
        o_ref[3, :] = il

    blk = 256
    spec = pl.BlockSpec((4, blk), lambda i: (0, i))
    out = pl.pallas_call(
        kernel, grid=(n // blk,), in_specs=[spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((4, n), jnp.float32),
        backend="triton", compiler_params=plt.CompilerParams(num_warps=4),
        name="ds32_step")(jnp.asarray(hi), jnp.asarray(lo))
    with jax.default_device(jax.devices("cpu")[0]):
        (rh, rl), (ih, il) = jax.jit(dd.quad_step)(
            *((jnp.asarray(hi[i]), jnp.asarray(lo[i])) for i in range(4)))
        on_cpu = np.stack([np.asarray(x) for x in (rh, rl, ih, il)])
    mismatch = float((np.asarray(out) != on_cpu).any(axis=0).mean())
    out = np.asarray(out, np.float64)
    zr, zi, cr, ci = z
    want_r = zr * zr - zi * zi + cr
    want_i = 2.0 * zr * zi + ci
    scale = np.maximum.reduce([zr * zr, zi * zi, np.abs(cr), np.abs(ci),
                               np.abs(2.0 * zr * zi)])
    err = np.maximum(np.abs(out[0] + out[1] - want_r),
                     np.abs(out[2] + out[3] - want_i)) / scale
    return mismatch, float(err.max() / 2.0 ** -48)


def _timed(fn, repeats=3):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_wall = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return compile_wall, float(np.median(ts))


def timing():
    """Each kernel's render program against its XLA twin's, warm p50."""
    import jax.numpy as jnp

    from fractal_tpu.config import Scene
    from fractal_tpu.ops import perturb as pt
    from fractal_tpu.ops.escape_pallas import scene_params
    from fractal_tpu.render import _render_escape_pallas_jit

    head = Scene(width=3000, height=3000, iterations=4000,
                 pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                 exposure=5.0, inside=False)
    julia = Scene(algo="julia", width=1920, height=1080, iterations=300,
                  julia_set=(-0.8, 0.156), scale=(0.4, 0.4), pos=(0.0, 0.0))
    rows = []
    for name, sc, prec in (("K1 julia 1080p f32", julia, "f32"),
                           ("K1 headline f64", head, "f64"),
                           ("K1 headline ds32", head, "ds32")):
        p = scene_params(sc, dtype=jnp.float64 if prec == "f64"
                         else jnp.float32)
        for impl in ("triton", "xla"):
            c, w = _timed(lambda: _render_escape_pallas_jit(sc, p, prec,
                                                            impl))
            rows.append((name, impl, c, w))

    deep15 = Scene(width=1920, height=1080, iterations=5000,
                   pos=(-0.74364388703715871, 0.13182590420531198),
                   scale=(1e15, 1e15), inside=False)
    for name, sc, fast in (
            ("K2 headline p32", head.replace(precision="p32"), True),
            ("K2 1e12 3000^2 exact grid", head.replace(
                scale=(1e12, 1e12),
                pos=(-0.74364388703715871, 0.13182590420531198)), False),
            ("K2 1e15 1080p exact grid", deep15, False)):
        w_, h_ = sc.width, sc.height
        ref, orbit = pt.resolve_reference(sc, w_, h_)
        P = pt._pert_params(sc, ref, w_, h_, orbit=orbit)
        ns = jnp.int32(orbit.n_steps)
        packed = pt._packed_for(sc, orbit, ref, w_, h_, fast)
        kern = (pt._render_perturb_kernel_fast_jit if fast
                else pt._render_perturb_kernel_jit)
        c, w = _timed(lambda: kern(sc, packed, P, ns, height=h_, width=w_))
        rows.append((name, "triton", c, w))
        c, w = _timed(lambda: pt._render_perturb_jit(
            sc, packed, P, ns, height=h_, width=w_, chunk=pt.PERT_CHUNK))
        rows.append((name, "xla", c, w))

    # the floatexp tier runs the XLA twin only
    fe = Scene(width=768, height=512, iterations=2000,
               pos_str=("-1.99999999999999999999999999999999999999999999"
                        "91", "0.0"), scale=(1e44, 1e44), inside=False)
    h_, w_, _, ref, orbit, P, ns, dev = pt._perturb_setup(fe, False)
    c, w = _timed(lambda: pt._render_perturb_jit(
        fe, dev[0], P, ns, height=h_, width=w_, chunk=pt.PERT_CHUNK,
        bla_packed=dev[1], bla_offsets=dev[2], extreme=True))
    rows.append(("floatexp 1e44 768x512", "xla", c, w))
    for name, impl, c, w in rows:
        _log(f"  timing {name} [{impl}]: compile wall {c:.2f} s, "
             f"warm p50 {w * 1e3:.1f} ms")
    return rows


def _clear_view_caches():
    from fractal_tpu.ops import perturb as pt

    for name in dir(pt):
        cache = getattr(pt, name)
        if name.endswith("_CACHE") and isinstance(cache, dict):
            cache.clear()


def mesh_phase(n: int, scenes=None):
    """The sharded paths on n devices against the single-device render on
    device 0; every sharded output must live on all n devices."""
    import jax

    from fractal_tpu.animate import render_zoom_sweep
    from fractal_tpu.config import Scene, scene_defaults
    from fractal_tpu.models.fern import render_fern
    from fractal_tpu.ops.perturb import render_perturb
    from fractal_tpu.parallel.sharding import (
        make_mesh, render_escape_sharded, render_fern_sharded,
        render_perturb_sharded,
    )
    from fractal_tpu.render import _render_escape_pallas_jit, escape_impl, \
        params_dtype
    from fractal_tpu.ops.escape_pallas import scene_params

    if len(jax.devices()) < n:
        raise RuntimeError(f"--devices {n}: JAX sees {len(jax.devices())}")
    mesh = make_mesh(n)
    if scenes is None:
        head = Scene(width=3000, height=3000, iterations=4000,
                     pos=(-0.7436447860, 0.1318252536), scale=(1e6, 1e6),
                     exposure=5.0, inside=False)
        scenes = {
            "escape": head,
            "fern": scene_defaults("fern").replace(
                width=750, height=500, iterations=10_000_000),
            "deep": head.replace(
                scale=(1e12, 1e12),
                pos=(-0.74364388703715871, 0.13182590420531198)),
            "sweep": Scene(width=640, height=360, iterations=1500,
                           pos=(-0.74364388703715871, 0.13182590420531198),
                           scale=(1e12, 1e12), inside=False),
        }

    def spread(name, x):
        devs = x.sharding.device_set
        if len(devs) != n:
            raise AssertionError(f"{name}: output on {len(devs)} device(s)")

    def same(name, got, want, tol=TOL["mesh_pixel_mismatch"]):
        got, want = np.asarray(got), np.asarray(want)
        diff = float((got != want).any(axis=-1).mean())
        check(f"mesh {name} pixel mismatch", diff, tol)

    for prec in ("f32", "f64"):
        sc = scenes["escape"].replace(precision=prec)
        got = render_escape_sharded(sc, mesh)
        spread(f"escape {prec}", got)
        want = _render_escape_pallas_jit(
            sc, scene_params(sc, dtype=params_dtype(prec)), prec,
            escape_impl(prec))
        same(f"escape {prec}", got, want)

    got = render_fern_sharded(scenes["fern"], mesh)
    spread("fern", got)
    same("fern", got, render_fern(scenes["fern"]))

    for prec in ("p32", "perturb"):
        sc = scenes["deep"].replace(precision=prec)
        # both renders start from empty view caches, so the exact tier's
        # multi-reference resolve walks the same secondary references
        _clear_view_caches()
        got = render_perturb_sharded(sc, mesh, fast=prec == "p32")
        _clear_view_caches()
        spread(f"perturb {prec}", got)
        same(f"perturb {prec}", got, render_perturb(sc, fast=prec == "p32"),
             TOL["mesh_pixel_mismatch" if prec == "p32"
                 else "mesh_perturb_pixel_mismatch"])

    sc = scenes["sweep"]
    scales = np.geomspace(0.4, sc.scale[0], 8)
    got = render_zoom_sweep(sc, scales, device_resident=True, mesh=mesh)
    spread("zoom sweep", got)
    same("zoom sweep", got, render_zoom_sweep(sc, scales))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the mesh phase, over four cards")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX found the "
                 f"{jax.default_backend()!r} backend")
    jax.config.update("jax_enable_x64", True)
    from fractal_tpu.utils.compile_cache import enable as enable_cache

    enable_cache()
    phases = Phases()
    phases.run("identity", identity)
    if args.devices == 4:
        phases.run("mesh", mesh_phase, 4)
    else:
        phases.run("build", build)
        out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            phases.run("cli", cli_renders, out_dir)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        phases.run("parity", parity)
        phases.run("timing", timing)
    _log("phase walls: " + ", ".join(f"{k} {v:.1f} s"
                                     for k, v in phases.walls.items()))
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
