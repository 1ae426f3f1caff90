"""Benchmark harness — prints ONE JSON line.

Headline config (BASELINE.md): 3000×3000 Mandelbrot at 1,000,000× zoom,
max-iter 4000 (the reference's deepest documented recipe, examples.md:29;
its README claims ~1 s for this on an all-core laptop CPU — ~9 Mpixel/s).

Measures the GPU only: on any other backend it exits non-zero without a
number.  Compile excluded (two warmups), p50 of repeated runs; every line
names the backend, ``device_kind`` and the device count.

The JSON line is kept compact; its length is pinned by
``tests/test_bench.py`` at ≤ 1,800 bytes fully populated.  Field glossary
(details): ``mps`` = Mpixels/s, ``cold``/``warm`` = first / second call
wall ms (trace+compile+run vs no-recompile), ``exact_ms`` = the default
ladder's (f64) p50, ``cfg`` = per-config rows (``ms`` p50, ``mps``,
``cold``, ``warm``, ``prec`` precision route, ``nres`` residual glitched
pixels — must be 0), ``times`` = headline repeat wall ms.  Config keys:
m4k_ss2=mandel_4k_ss2_smooth, mb3_2k=multibrot_d3_2k,
dz1e12=deepzoom_3000sq_1e12, bship_2k=burning_ship_2k, fern_100m/fern_10m,
p1e15=perturb_1080p_1e15, fe1e44=extreme_768x512_1e44,
bla1e40=minibrot_512x384_1e40_bla, fe1e44_11k=extreme_768x512_1e44_11k,
jsweep256=julia_sweep_256f_1080p, mp100=100 MP device render (10000²,
device-side checksum fence — no 300 MB host fetch).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp

REFERENCE_SECONDS = 1.0  # README.md:9-11: ~1 s on CPU for this render
LINE_BUDGET = 1800  # one line, short enough for a 2,000-byte tail capture


def headline_scene():
    from fractal_tpu.config import Scene

    return Scene(
        algo="mandelbrot",
        width=3000,
        height=3000,
        iterations=4000,
        pos=(-0.7436447860, 0.1318252536),
        scale=(1e6, 1e6),
        exposure=5.0,
        inside=False,
    )


def bench_render(scene, repeats: int = 5, backend: str = "auto"):
    from fractal_tpu.render import render_u8

    def fence(img):
        # a device-side checksum fetched to the host: waits for the render
        # and keeps the 100 MP row device-only (the 300 MB image never
        # crosses to the host, just this scalar)
        return float(jnp.sum(img, dtype=jnp.int32)[None][0])

    # warmup / compile (render + fence programs) — twice: paths with a
    # cached-after-first-frame fallback (deep-zoom multiref) compile their
    # warm-frame program only on the second call.  Both warmup walls are
    # timed: cold = trace+compile+run (served from the persistent XLA
    # cache when populated), warm = second call, no recompile.
    t0 = time.perf_counter()
    fence(render_u8(scene, backend=backend))
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    fence(render_u8(scene.replace(exposure=scene.exposure * (1 + 1e-12)),
                    backend=backend))
    t_warm = time.perf_counter() - t0
    times = []
    for i in range(repeats):
        # Perturb a traced leaf per repeat (no recompile — exposure is a
        # dynamic pytree field) so no layer can dedupe identical dispatches.
        sc = scene.replace(exposure=scene.exposure * (1.0 + 1e-9 * (i + 1)))
        t0 = time.perf_counter()
        fence(render_u8(sc, backend=backend))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times, (t_cold, t_warm)


def _prec_token(scene):
    """Short precision-route token for the JSON line ("fe" = floatexp)."""
    from fractal_tpu.render import resolve_precision

    prec = resolve_precision(scene)
    if prec == "perturb":
        from fractal_tpu.ops.perturb import _is_extreme

        if _is_extreme(scene):
            return "fe"
    return prec


def _bench_config(scene, repeats, backend):
    p50, times, (t_cold, t_warm) = bench_render(scene, repeats, backend)
    stats = {
        "ms": round(p50 * 1e3, 1),
        "mps": round(scene.width * scene.height / p50 / 1e6, 1),
        "cold": int(round(t_cold * 1e3)),
        "warm": int(round(t_warm * 1e3)),
    }
    if scene.algo != "fern":
        stats["prec"] = _prec_token(scene)
        if stats["prec"] in ("perturb", "fe"):
            # residual glitched pixels after the exact resolve — the
            # zero-best-effort contract; nonzero is a bug
            from fractal_tpu.ops.perturb import RENDER_STATS

            stats["nres"] = int(RENDER_STATS.get("n_residual", 0) or 0)
    return p50, stats


def baseline_configs():
    """BASELINE.json configs 2-5 (the headline is config 1).  Key map in
    the module docstring."""
    from fractal_tpu.config import Scene

    return {
        "julia_1080p": Scene(
            algo="julia", width=1920, height=1080, iterations=300,
            julia_set=(-0.8, 0.156), scale=(0.4, 0.4), pos=(0.0, 0.0),
        ),
        "m4k_ss2": Scene(
            width=3840, height=2160, iterations=600, supersample=2,
            pos=(-0.743643, 0.131825), scale=(5000.0, 5000.0),
        ),
        "mb3_2k": Scene(
            algo="multibrot", power=3, width=2000, height=2000,
            iterations=300, pos=(0.0, 0.0), scale=(0.35, 0.35),
        ),
        "dz1e12": Scene(
            width=3000, height=3000, iterations=4000,
            pos=(-0.74364388703715871, 0.13182590420531198),
            scale=(1e12, 1e12), inside=False,
        ),
    }


# a deep minibrot-adjacent center (iterative max-count recentering to
# 1e41): the orbit contracts near the minibrot cycle, the regime deep
# zooms actually target (and where the fe BLA table is valid)
_MINIBROT_1E40_X = "-157996253097964571301972830522288002021514947629178379711098185808257073039470695158211500112900838145522465809142611009023639565445383101084883134484682610353514940624481200762246007439/212462249541855969823564443888867658718504667147683695179167999373230694241283933429894861838275817718252008213801240896439140775510819546312539219637043200000000000000000000000000000000"
_MINIBROT_1E40_Y = "28008028155349122668929932079246027544335248782475580605078491147016246379854728339564574920280759962068701281864864148011241416251870231103204751712607560043470776143225258105876903281/212462249541855969823564443888867658718504667147683695179167999373230694241283933429894861838275817718252008213801240896439140775510819546312539219637043200000000000000000000000000000000"


def longtail_configs():
    """Long-tail configs."""
    from fractal_tpu.config import Scene, scene_defaults

    return {
        "bship_2k": Scene(
            algo="burningship", width=2000, height=2000, iterations=500,
            pos=(-0.45, -0.5), scale=(0.8, 0.8),
        ),
        "fern_100m": scene_defaults("fern").replace(
            width=2000, height=2000, iterations=100_000_000,
        ),
        # the reference's own default fern workload: 10M iterations at the
        # default 750x500 canvas (reference calc/src/lib.rs:43-45,
        # src/lib.rs:32-41)
        "fern_10m": scene_defaults("fern").replace(
            width=750, height=500, iterations=10_000_000,
        ),
        # beyond the reference's f64 wall: perturbation w/ exact orbit walk
        "p1e15": Scene(
            width=1920, height=1080, iterations=5000,
            pos=(-0.74364388703715871, 0.13182590420531198),
            scale=(1e15, 1e15), inside=False,
        ),
        # extreme depth (floatexp XLA twin): 29 orders past f64
        "fe1e44": Scene(
            width=768, height=512, iterations=2000,
            pos_str=("-1.9999999999999999999999999999999999999999999"
                     "91", "0.0"),
            scale=(1e44, 1e44), inside=False,
        ),
        # contracting (minibrot) 1e40x view: the extended-exponent BLA
        # table fires at every merge level here; the needle view above gets
        # ZERO valid radii
        "bla1e40": Scene(
            width=512, height=384, iterations=4000,
            pos_str=(_MINIBROT_1E40_X, _MINIBROT_1E40_Y),
            scale=(1e40, 1e40), inside=False,
        ),
        # an 11k-iteration budget at extreme depth
        "fe1e44_11k": Scene(
            width=768, height=512, iterations=11000,
            pos_str=("-1.9999999999999999999999999999999999999999999"
                     "91", "0.0"),
            scale=(1e44, 1e44), inside=False,
        ),
        # 100 MP capability row: rendered and checksummed on-device — the
        # fence's scalar sum is the only host transfer (reference claim:
        # src/lib.rs:36-41)
        "mp100": Scene(
            width=10000, height=10000, iterations=500, exposure=5.0,
        ),
    }


def device_identity():
    """(backend, device_kind, device count) as JAX reports them."""
    d = jax.devices()[0]
    return jax.default_backend(), d.device_kind, len(jax.devices())


def assemble_result(*, p50, times, t_cold, t_warm, p50_exact, t_cold_exact,
                    configs, device):
    """The JSON line as a dict — shared by main() and the length-pinning
    test so the ≤LINE_BUDGET contract covers the real assembly path.
    ``device`` is ``device_identity()``."""
    scene_px = 3000 * 3000
    return {
        "metric": "mandelbrot 3000x3000 @1e6x zoom, 4000 max-iter, "
                  "render time (p32 fast tier)",
        "value": round(p50 * 1e3, 2),
        "unit": "ms",
        "vs_baseline": round(REFERENCE_SECONDS / p50, 2),
        "details": {
            "mps": round(scene_px / p50 / 1e6, 1),
            "backend": device[0],
            "kind": device[1],
            "count": device[2],
            "exact_ms": round(p50_exact * 1e3, 1),
            "times": [round(t * 1e3, 1) for t in times],
            "cold": int(round(t_cold * 1e3)),
            "warm": int(round(t_warm * 1e3)),
            "cold_exact": int(round(t_cold_exact * 1e3)),
            "cfg": configs,
        },
    }


def emit(result) -> str:
    """Serialize + length-guard the one line."""
    import sys

    line = json.dumps(result, separators=(",", ":"))
    if len(line) > LINE_BUDGET:
        print(f"# WARNING: JSON line {len(line)} B exceeds the "
              f"{LINE_BUDGET} B budget (driver tail capture is 2000 B)",
              file=sys.stderr)
    print(line)
    return line


def main():
    import sys

    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found the "
                 f"{jax.default_backend()!r} backend — no number printed")
    # persistent XLA compile cache (same as the CLI)
    from fractal_tpu.utils.compile_cache import enable as _enable_cache

    _enable_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--headline-only", action="store_true",
                    help="skip the secondary configs")
    args = ap.parse_args()

    scene = headline_scene()
    # Fast tier (p32: f32 δ-orbits — >99.9% classification accuracy,
    # boundary counts carry f32 noise, PERF.md) is the headline number; the
    # default ladder's (f64) time rides along as exact_ms.
    p50, times, (t_cold, t_warm) = bench_render(
        scene.replace(precision="p32"), args.repeats, args.backend)
    p50_exact, _, (t_cold_exact, _tw) = bench_render(
        scene, max(2, args.repeats // 2), args.backend)

    configs = {}
    if not args.headline_only:
        for name, sc in {**baseline_configs(), **longtail_configs()}.items():
            try:
                _, stats = _bench_config(sc, max(2, args.repeats // 2),
                                         args.backend)
                configs[name] = stats
            except Exception as e:  # keep the harness alive per-config
                configs[name] = {"error": str(e)[:120]}
                print(f"# {name}: FAILED {e}", file=sys.stderr)
        # BASELINE config 2: 256-frame julia sweep @1080p, one device
        # program.  p50 of ≥3 timed repeats with the min/max spread.
        try:
            import numpy as _np

            from fractal_tpu import animate
            from fractal_tpu.config import Scene as _S

            cs = animate.julia_c_path(_np.linspace(0, 1, 256, endpoint=False))
            scenes = [_S(algo="julia", width=1920, height=1080,
                         iterations=300, julia_set=(float(a), float(b)),
                         pos=(0.0, 0.0), scale=(0.4, 0.4)) for a, b in cs]
            t0 = time.perf_counter()
            out = animate.render_sweep(scenes, device_resident=True)
            float(jnp.sum(out[:1].astype(jnp.int32)))  # warm + compile wall
            sweep_cold = time.perf_counter() - t0
            sweep_times = []
            for i in range(max(3, args.repeats)):
                t0 = time.perf_counter()
                out = animate.render_sweep(
                    [s.replace(exposure=5.0 + 1e-9 * (i + 1))
                     for s in scenes], device_resident=True)
                float(jnp.sum(out.astype(jnp.int32)))
                sweep_times.append(time.perf_counter() - t0)
            sp50 = statistics.median(sweep_times)
            configs["jsweep256"] = {
                "s": round(sp50, 2), "fps": round(256 / sp50, 1),
                "s_minmax": [round(min(sweep_times), 2),
                             round(max(sweep_times), 2)],
                "cold": int(round(sweep_cold * 1e3)),
            }
        except Exception as e:
            configs["jsweep256"] = {"error": str(e)[:120]}
            print(f"# julia_sweep: FAILED {e}", file=sys.stderr)

    emit(assemble_result(
        p50=p50, times=times, t_cold=t_cold, t_warm=t_warm,
        p50_exact=p50_exact, t_cold_exact=t_cold_exact, configs=configs,
        device=device_identity()))


if __name__ == "__main__":
    main()
