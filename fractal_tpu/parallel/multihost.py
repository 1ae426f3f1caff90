"""Multi-host launch support (DCN) — SURVEY.md §5 "distributed backend".

The reference is a single shared-memory process; its only "collective" is
rayon's in-memory join.  This framework's collectives (the fern psum, the
escape stripes' output layout) already run across the devices of one
host; this module is the thin entry for *multi-host* meshes, where JAX needs
every host to call ``jax.distributed.initialize`` before any device API.

Usage (one process per host, e.g. under a cluster resource manager):

    from fractal_tpu.parallel import multihost
    multihost.initialize()              # env-driven where the runtime supports it
    mesh = make_mesh()                  # now spans all hosts' devices
    img = render_escape_sharded(scene, mesh)

Where the cluster runtime provides the coordinator address / process ids,
``initialize()`` needs no arguments; elsewhere pass them explicitly
(``coordinator_address``, ``num_processes``, ``process_id``).  Single-process runs are a no-op — every entry point in this
package works unchanged without calling this.
"""

from __future__ import annotations

from typing import Optional

import jax


_initialized = False


_status = "not-initialized"


def _distributed_client_up() -> bool:
    """True iff jax.distributed.initialize has already run in this process
    (e.g. a pod launcher called it before us).

    Deliberately avoids ``jax.process_count()``: that call initializes the
    XLA backend as a side effect, and the distributed client can only be
    created *before* backend initialization.  Probes the public
    ``jax.distributed.is_initialized`` first; the private global-state
    check is only the fallback for jax versions without it.
    """
    try:
        return bool(jax.distributed.is_initialized())
    except AttributeError:
        pass
    try:
        from jax._src import distributed as _dist

        return _dist.global_state.client is not None
    except Exception:  # private-API drift: fall back to "not up"
        return False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               initialization_timeout: Optional[int] = None) -> None:
    """Join the multi-host cluster (idempotent; no-op if already joined).

    All arguments optional where the cluster runtime supplies them.  Must be
    called before any other JAX API touches devices.

    Failure semantics (r1 swallowed everything): with EXPLICIT coordinator
    arguments the caller clearly intends a multi-host launch, so any
    failure (unreachable coordinator, backend already initialized, bad
    ids) RAISES.  Only the env-driven no-argument form treats "nothing to
    join" as a clean single-host no-op; ``status()`` reports which case
    happened.
    """
    global _initialized, _status
    # NB: must not probe jax.process_count() here — that initializes the
    # XLA backend, after which jax.distributed.initialize refuses to run.
    up = _distributed_client_up()
    if _initialized or up:
        _initialized = True
        if up:
            _status = "joined"
        return
    explicit = coordinator_address is not None
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    if initialization_timeout is not None:
        kw["initialization_timeout"] = initialization_timeout
    try:
        jax.distributed.initialize(**kw)
        _status = "joined"
    except (ValueError, RuntimeError) as e:
        if explicit:
            # an explicit coordinator that cannot be joined is an error,
            # not a silent single-host fallback
            raise RuntimeError(
                f"multi-host initialize failed for coordinator "
                f"{coordinator_address!r}: {e}") from e
        # env-driven form: ValueError = single-process environment without
        # coordinator configuration (nothing to join); RuntimeError = the
        # XLA backend is already up (a real pod launch calls initialize()
        # first, so this is the single-host case, e.g. a test suite).
        _status = f"single-host ({type(e).__name__})"
    _initialized = True


def status() -> str:
    """'joined', 'single-host (...)', or 'not-initialized'."""
    return _status


def is_multihost() -> bool:
    return jax.process_count() > 1


def local_row_range(height: int) -> tuple:
    """The contiguous output-row range this host owns when assembling a
    sharded render to per-host files (each host writes only its rows
    instead of all-gathering a 100MP image over DCN)."""
    p = jax.process_count()
    i = jax.process_index()
    rows = -(-height // p)
    lo = min(i * rows, height)
    return lo, min(lo + rows, height)
