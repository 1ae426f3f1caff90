"""ctypes bindings to the native high-precision orbit walker
(native/orbitwalk.cpp), and the exact Fraction → raw-mpf conversion that
feeds it.

The high-precision reference-orbit walk is the dominant cost of every cold
deep frame; orbitwalk.cpp implements mpmath's arbitrary-precision
arithmetic bit-for-bit (same raw-mpf rounding, same per-algo op sequence as
the mpmath loops the tests keep as the oracle) and runs the loop natively.
``walk()`` returns exactly what the mpmath loop would have produced — f64
orbit rows and the break index — or ``None`` when the walk would leave the
replicated paths.  Without the library the walk fails with a clear error:
``make -C native`` builds it.

Numbers cross the boundary as mpmath's raw mpf tuples ``(sign, man, exp,
bc)`` (value = (-1)^sign · man · 2^exp, man odd), built from exact
``Fraction``s by ``mpf_from_fraction`` with plain integer arithmetic — the
main path needs no mpmath.

The reference walks its orbit in plain f64 (calc/src/lib.rs:205-231); the
high-precision walker has no reference counterpart — it exists for the
deep-zoom tier the reference stalled on.
"""

from __future__ import annotations

import ctypes
import os
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

_LIB = None
_TRIED = False

_ALGO_IDS = {"zsq": 0, "zpow": 1, "burningship": 2, "tricorn": 3}


def _lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "liborbitwalk.so")


def _try_build(path: str) -> None:
    """Build liborbitwalk.so on first use (fresh checkouts have no
    binaries).  A failed build leaves the library missing, which ``walk``
    and ``direct`` then report."""
    import shutil
    import subprocess

    src_dir = os.path.dirname(path)
    if not os.path.exists(os.path.join(src_dir, "orbitwalk.cpp")):
        return
    if shutil.which("make") is None:
        return
    try:
        subprocess.run(
            ["make", "-C", src_dir, "liborbitwalk.so"],
            capture_output=True, timeout=120, check=False,
        )
    except Exception:
        pass


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        _try_build(path)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        if lib.orbitwalk_abi_version() != 1:
            _LIB = None
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.orbitwalk_run.argtypes = (
            [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
            + [ctypes.c_int, ctypes.c_longlong, u8p, ctypes.c_longlong] * 4
            + [ctypes.c_longlong, ctypes.c_double,
               ctypes.POINTER(ctypes.c_double)]
        )
        lib.orbitwalk_run.restype = ctypes.c_longlong
        lib.orbitwalk_direct.argtypes = lib.orbitwalk_run.argtypes
        lib.orbitwalk_direct.restype = ctypes.c_longlong
        _LIB = lib
    except (OSError, AttributeError):
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def dps_to_prec(dps: int) -> int:
    """Working precision in bits for ``dps`` decimal digits — mpmath's
    ``workdps`` rule (libmpf.dps_to_prec)."""
    return max(1, int(round((int(dps) + 1) * 3.3219280948873626)))


def _normalize(sign: int, man: int, exp: int, prec: int):
    """Round man·2^exp (man ≥ 0) to ``prec`` bits, nearest with ties to
    even, and strip trailing zero bits — libmpf.normalize at round-nearest.
    """
    if not man:
        return (0, 0, 0, 0)
    bc = man.bit_length()
    if bc > prec:
        n = bc - prec
        t = man >> (n - 1)
        if t & 1 and ((t & 2) or (man & ((1 << (n - 1)) - 1))):
            man = (t >> 1) + 1
        else:
            man = t >> 1
        exp += n
    tz = (man & -man).bit_length() - 1
    return (sign, man >> tz, exp + tz, (man >> tz).bit_length())


def mpf_from_fraction(v: Fraction, prec: int):
    """Raw mpf of ``mpf(v.numerator) / v.denominator`` at ``prec`` bits —
    the numerator rounded to ``prec`` bits, then a correctly rounded
    division by the exact denominator (libmpf.from_int + mpf_div)."""
    sign, sman, sexp, sbc = _normalize(1 if v < 0 else 0, abs(v.numerator),
                                       0, prec)
    den = v.denominator
    if not sman or den == 1:
        return (sign, sman, sexp, sbc)
    texp = (den & -den).bit_length() - 1
    tman = den >> texp
    if tman == 1:
        return _normalize(sign, sman, sexp - texp, prec)
    extra = max(prec - sbc + tman.bit_length() + 5, 5)
    quot, rem = divmod(sman << extra, tman)
    if rem:
        # a sticky bit below the kept range: nearest-even then rounds
        # exactly as the infinitely precise quotient would
        quot = (quot << 1) + 1
        extra += 1
    return _normalize(sign, quot, sexp - texp - extra, prec)


def _mpf_args(raw):
    """(sign, man_bytes, exp) ctypes args from an mpmath raw mpf tuple.
    Returns None for non-finite specials (never produced by a walk, but
    the guard keeps the fallback airtight)."""
    sign, man, exp, bc = raw
    if man == 0 and exp != 0:  # inf/nan
        return None
    buf = int(man).to_bytes((int(bc) + 7) // 8, "little") if man else b""
    arr = (ctypes.c_uint8 * max(len(buf), 1)).from_buffer_copy(buf or b"\0")
    return (ctypes.c_int(int(sign)), ctypes.c_longlong(int(exp)),
            ctypes.cast(arr, ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_longlong(len(buf)), arr)


def _call(fn_name: str, algo: str, power: int, prec: int, z0, c,
          iters: int, limit_sq: float, out: np.ndarray):
    """Shared arg packing for the two walker entry points.  ``z0``/``c``
    are (re, im) pairs of raw mpf tuples.  Returns the break index n, or
    None when the walk leaves the replicated paths."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "the native orbit walker (native/liborbitwalk.so) is not built "
            "and could not be built here; run `make -C native` first")
    # eff_power semantics live in the caller; here d == 2 means the
    # quadratic fast path, d >= 3 the exact complex-int-pow path
    if algo in ("mandelbrot", "julia", "multibrot"):
        kind = "zsq" if power == 2 else "zpow"
    elif algo in ("burningship", "tricorn"):
        kind = algo
    else:
        return None
    packed = []
    for raw in (z0[0], z0[1], c[0], c[1]):
        a = _mpf_args(raw)
        if a is None:
            return None
        packed.append(a)
    args = [ctypes.c_int(_ALGO_IDS[kind]), ctypes.c_longlong(int(power)),
            ctypes.c_longlong(int(prec))]
    for a in packed:
        args.extend(a[:4])  # a[4] keeps the byte buffer alive
    args.extend([ctypes.c_longlong(int(iters)), ctypes.c_double(limit_sq),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))])
    n = getattr(lib, fn_name)(*args)
    if n < 0:
        return None
    return int(n)


def walk(algo: str, power: int, prec: int, z0, c, iters: int,
         limit_sq: float) -> Optional[Tuple[np.ndarray, int]]:
    """The high-precision orbit walk of ``perturb.reference_orbit``.

    ``z0``/``c`` are (re, im) pairs of raw mpf tuples at working precision
    ``prec`` bits; returns ``(zs, n)`` with ``zs`` the (iters+1, 2) f64
    array holding rows 0..n (rows past n are uninitialized), or ``None``
    when the walk leaves the replicated paths."""
    zs = np.empty((iters + 1, 2), np.float64)
    n = _call("orbitwalk_run", algo, power, prec, z0, c, iters, limit_sq,
              zs)
    if n is None:
        return None
    return zs, n


def direct(algo: str, power: int, prec: int, z0, c, iters: int,
           limit_sq: float) -> Optional[Tuple[float, float, int]]:
    """``perturb._direct_resolve``'s per-pixel loop (mpf-exact escape
    test, escaping step not counted).  Returns (zr, zi, n) as the mpmath
    loop's float(z.real)/float(z.imag)/n, or None when the walk leaves the
    replicated paths."""
    out = np.empty(2, np.float64)
    n = _call("orbitwalk_direct", algo, power, prec, z0, c, iters,
              limit_sq, out)
    if n is None:
        return None
    return float(out[0]), float(out[1]), n
