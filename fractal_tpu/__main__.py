"""Binary entry point: ``python -m fractal_tpu ...`` — the reference's
main() dispatch (src/main.rs:4-23): GUI when -g, else batch render + encode.
"""

from __future__ import annotations

import sys

from fractal_tpu.cli import parse_options
from fractal_tpu.utils.timing import Phases


def _mesh_for(options):
    """The --devices N mesh (None for the default single-device path)."""
    from fractal_tpu.parallel.sharding import mesh_for_devices

    return mesh_for_devices(options.devices)


def main(argv=None) -> int:
    try:
        return _main(argv)
    except ValueError as e:
        # Render-time configuration errors (e.g. perturbation precision on a
        # non-quadratic algo, stale checkpoint manifest) exit like argparse
        # errors — a clean one-line message, not a traceback.
        sys.exit(f"error: {e}")


def _main(argv=None) -> int:
    options = parse_options(argv)

    from fractal_tpu.utils.compile_cache import enable as _enable_cache

    _enable_cache()

    if options.gui:
        from fractal_tpu.viewer import start

        start(options)
        return 0

    phases = Phases(enabled=options.profile)
    from fractal_tpu.render import render_u8
    from fractal_tpu.io import open_in_viewer, write_image

    import contextlib

    trace_cm = contextlib.nullcontext()
    if options.trace:
        import jax.profiler

        trace_cm = jax.profiler.trace(options.trace)

    if options.animate:
        return _render_animation(options, phases, trace_cm)

    with trace_cm:
        if options.bands:
            from fractal_tpu.tiled import render_tiled

            mesh = _mesh_for(options)
            with phases.phase("render (banded)" if mesh is None else
                              f"render (banded, {mesh.devices.size}-device)"):
                img = render_tiled(options.scene, options.bands,
                                   options.ckpt_dir,
                                   progress=print if options.profile else None,
                                   mesh=mesh)
        elif options.devices != 1:
            # Multi-device still render (SURVEY §2 C7/C9): rows
            # interleaved across the mesh for escape scenes, the fern's
            # walker set sliced per device with its integer histograms
            # psum-combined — both bit-identical to single-device
            # (tests/test_sharding.py).
            import jax
            import numpy as np

            from fractal_tpu.parallel.sharding import (
                render_escape_sharded, render_fern_sharded,
            )

            mesh = _mesh_for(options)
            with phases.phase(f"render ({mesh.devices.size}-device mesh)"):
                if options.scene.algo == "fern":
                    img_dev = render_fern_sharded(options.scene, mesh)
                else:
                    img_dev = render_escape_sharded(
                        options.scene, mesh, backend=options.backend)
            with phases.phase("device→host"):
                img = np.asarray(jax.device_get(img_dev))
        else:
            with phases.phase("render (device)"):
                img_dev = render_u8(options.scene, backend=options.backend)
            with phases.phase("device→host"):
                import jax
                import numpy as np

                img = np.asarray(jax.device_get(img_dev))
    with phases.phase("encode+write"):
        path = write_image(img, options.filename, options.fmt)
    phases.report()
    if options.profile:
        # perturbation-depth observability: glitch pixel count and any unresolved multiref residual for this render
        from fractal_tpu.ops.perturb import RENDER_STATS

        if RENDER_STATS.get("tier"):
            ng = RENDER_STATS.get("n_glitch")
            nres = RENDER_STATS.get("n_residual", 0)
            print(f"{'tier':>16s}: {RENDER_STATS['tier']}")
            if RENDER_STATS.get("route"):
                print(f"{'kernel route':>16s}: {RENDER_STATS['route']}")
            print(f"{'glitch pixels':>16s}: "
                  f"{'n/a (fast tier)' if ng is None else int(ng)}")
            if nres is not None and int(nres):
                # only the device-resident warm path can report this; the
                # cold-frame host resolve finishes every pixel exactly
                print(f"{'UNRESOLVED':>16s}: {int(nres)} pixel(s) pending "
                      f"exact resolve (warm-path transient)")
    if options.trace:
        print(f"trace written to {options.trace}")

    if options.open:
        open_in_viewer(path)
    return 0


def _render_animation(options, phases, trace_cm) -> int:
    """--animate N: one batched device program, frames written as a
    numbered sequence next to the still output name."""
    import numpy as np

    from fractal_tpu.io import write_image

    scene = options.scene
    n = options.animate
    # frame-parallel DP (frames shard across the mesh; bit-identical to
    # the single-device sweep — tests/test_sharding.py)
    mesh = _mesh_for(options)
    with trace_cm:
        with phases.phase("render (batched sweep)"
                          if mesh is None else
                          f"render ({mesh.devices.size}-device sweep)"):
            if options.sweep == "zoom":
                from fractal_tpu.animate import render_zoom_sweep

                start = options.zoom_from if options.zoom_from is not None else 0.4
                end = max(abs(scene.scale[0]), abs(scene.scale[1]))
                scales = np.geomspace(start, end, n)
                frames = render_zoom_sweep(scene, scales,
                                           exact=options.exact_sweep,
                                           mesh=mesh)
            else:
                from fractal_tpu.animate import julia_c_path, render_sweep

                cs = julia_c_path(np.linspace(0.0, 1.0, n, endpoint=False))
                frames = render_sweep(
                    [scene.replace(julia_set=(float(a), float(b)))
                     for a, b in cs], mesh=mesh)
    with phases.phase("encode+write"):
        paths = []
        for i in range(n):
            paths.append(write_image(frames[i], f"{options.filename}_{i:04d}",
                                     options.fmt))
    phases.report()
    print(f"wrote {n} frames: {paths[0]} ... {paths[-1]}")
    if options.open:
        from fractal_tpu.io import open_in_viewer

        open_in_viewer(paths[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
