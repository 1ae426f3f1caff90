"""Scene configuration — mirrors the reference `Config` semantics exactly.

Reference: calc/src/lib.rs:21-75 (`Config`, `Config::new`) and the RGB type
at calc/src/lib.rs:121-146.

Exact-semantics notes (SURVEY.md "Quirks"):

* The reference's ``RGB::new(r, b, g)`` constructor has its 2nd and 3rd
  arguments swapped (calc/src/lib.rs:129): the second argument lands in the
  *blue* field and the third in *green*.  The values *stored* in the
  reference's Config are therefore, in true (r, g, b) field order:

  - escape-time primary:   ``new(40, 40, 255)``  -> stored (40, 255, 40)
  - escape-time secondary: ``new(240, 170, 0)``  -> stored (240, 0, 170)
  - fern primary:          ``new(4, 100, 3)``    -> stored (4, 3, 100)
  - fern secondary (bg):   ``new(240, 240, 240)``-> stored (240, 240, 240)

  Crucially, ``color_multiply`` (calc:133-139) routes its output through the
  same swapped constructor, so escape-time rendering swaps g/b a SECOND time
  and the two swaps cancel: the reference binary's effective escape colors
  are the literal ``Config::new`` arguments — blue (40,40,255) primary,
  orange (240,170,0) secondary (its screenshot is blue-dominant, its CLI
  help calls the secondary "orange") — and hex input renders un-swapped.
  The fern path (``subtract_pixel``/background fill) has no cancelling
  second swap; its stored values are what the math sees.

  We store colors exactly as the reference stores them (post-constructor
  swap) and apply the render-time second swap in ``ops/coloring.py`` /
  the fern darkening recurrence in ``models/fern.py``, so rendered images
  match the reference binary pixel-for-pixel.  Hex parsing mirrors the
  parse-time swap (see ``parse_hex_rgb``).

* Two-tier defaults: ``Config::new`` sets exposure 2.0 (calc:52) but the CLI
  overrides it with default "5" (src/lib.rs:100).  ``scene_defaults`` mirrors
  ``Config::new``; the CLI layer (cli.py) applies its own defaults on top.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax

# ---------------------------------------------------------------------------
# RGB
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RGB:
    """A u8 color triple, stored in true (r, g, b) field order.

    Unlike the reference's ``RGB::new(r, b, g)`` (calc/src/lib.rs:129) the
    constructor here is straight (r, g, b); reference-effective defaults are
    pre-swapped in ``scene_defaults``.
    """

    r: int
    g: int
    b: int

    def __post_init__(self):
        for v in (self.r, self.g, self.b):
            if not (0 <= int(v) <= 255):
                raise ValueError(f"RGB channel out of range: {v}")

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.r, self.g, self.b)

    @staticmethod
    def reference_new(r: int, b: int, g: int) -> "RGB":
        """Compat shim replicating the reference's swapped constructor
        (calc/src/lib.rs:129): 2nd arg is BLUE, 3rd is GREEN."""
        return RGB(r, g, b)


BLACK = RGB(0, 0, 0)


def parse_hex_rgb(s: str, compat: bool = True) -> RGB:
    """Parse "RRGGBB" hex.

    With ``compat=True`` (default) replicates the reference's stored fields
    (src/lib.rs:22-28): the parsed G lands in the blue field and the parsed B
    in the green field, because ``parse_hex_rgb`` there feeds the swapped
    ``RGB::new``.  For escape-time scenes the render-time swap in
    ``color_multiply`` cancels this, so compat-parsed hex *renders* true;
    only the fern (no second swap) exposes the stored order.
    ``compat=False`` stores the literal RRGGBB.
    """
    s = s.removeprefix("#")
    if len(s) != 6:
        raise ValueError(f"hex color must be 6 digits, got {s!r}")
    r, g, b = (int(s[i : i + 2], 16) for i in (0, 2, 4))
    if compat:
        return RGB.reference_new(r, g, b)  # -> fields (r, g=b, b=g)
    return RGB(r, g, b)


# ---------------------------------------------------------------------------
# Algorithms
# ---------------------------------------------------------------------------

# Escape-time family (share the iterate-and-color pipeline); the fern is the
# chaos-game family.  The reference supports the first three
# (calc/src/lib.rs:150-154); multibrot/burningship/tricorn are new
# capabilities enabled by the generic iteration-rule kernel (BASELINE.md).
ESCAPE_ALGOS = ("mandelbrot", "julia", "multibrot", "burningship", "tricorn")
ALGOS = ESCAPE_ALGOS + ("fern",)


def normalize_algo(name: str) -> str:
    """Reference algo parsing is case-insensitive and accepts "barnsleyfern"
    for the fern (calc/src/lib.rs:166-179)."""
    s = name.lower()
    if s == "barnsleyfern":
        s = "fern"
    if s not in ALGOS:
        raise ValueError(f"invalid algorithm name: {name!r} (choose from {ALGOS})")
    return s


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Scene:
    """The full render configuration (reference `Config`, calc/src/lib.rs:21-37),
    plus framework extensions (power, supersample, precision, seed).

    Registered as a JAX pytree: continuous parameters (pos, scale, exposure,
    limits, colors-as-floats, julia_set) are traced leaves so a jitted render
    does not recompile when they change; shape/loop-structure parameters
    (width, height, iterations, algo, flags) are static aux data.
    """

    algo: str = "mandelbrot"
    width: int = 2000
    height: int = 1000
    iterations: int = 50
    limit: float = 2.0 ** 16
    stable_limit: float = 2.0
    pos: Tuple[float, float] = (0.0, 0.0)          # (re, im)
    scale: Tuple[float, float] = (0.4, 0.4)        # (re, im); larger = deeper zoom
    exposure: float = 2.0
    inside: bool = True
    smooth: bool = True
    primary_color: RGB = RGB(40, 255, 40)
    secondary_color: RGB = RGB(240, 0, 170)
    color_weight: float = 0.01
    julia_set: Tuple[float, float] = (0.0, 0.0)

    # --- extensions over the reference Config ---
    pos_str: object = None    # optional (re, im) decimal strings: exact
    #                           center for zooms past f64 (the floats in
    #                           `pos` then hold the nearest approximation)
    power: int = 2            # multibrot exponent d in z^d + c
    supersample: int = 1      # k×k supersampled anti-aliasing
    precision: str = "auto"   # auto | f32 | f64 | ds32 | dd64 | perturb | p32
    #                           (p32: f32 δ-orbit fast tier — see render.py)
    seed: int = 0             # fern chaos-game PRNG seed (reference is unseeded)
    fern_replicas: int = 1    # reference-compat N-replica saturating-sum mode

    def __post_init__(self):
        object.__setattr__(self, "algo", normalize_algo(self.algo))
        if self.pos_str is not None:
            from fractions import Fraction

            try:
                fr = tuple(Fraction(str(v)) for v in self.pos_str)
            except (ValueError, ZeroDivisionError) as e:
                raise ValueError(f"invalid pos_str {self.pos_str!r}: {e}")
            object.__setattr__(self, "pos_str",
                               (str(self.pos_str[0]), str(self.pos_str[1])))
            object.__setattr__(self, "pos", (float(fr[0]), float(fr[1])))
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if self.iterations < 0:
            raise ValueError("iterations must be >= 0")
        if self.supersample < 1:
            raise ValueError("supersample must be >= 1")
        if self.precision not in ("auto", "f32", "f64", "ds32", "dd64",
                                  "perturb", "p32"):
            raise ValueError(f"unknown precision {self.precision!r}")

    # -- helpers ----------------------------------------------------------

    @property
    def pixel_spacing(self) -> float:
        """Complex-plane distance between adjacent pixels: the viewport
        transform divides by (height * scale) (calc/src/lib.rs:181-184)."""
        return 1.0 / (self.height * min(abs(self.scale[0]), abs(self.scale[1])) + 1e-300)

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


def exact_pos(scene: "Scene"):
    """The view center as exact rationals: from the decimal strings when
    given (sub-f64 centers for deep zooms), else the f64 values."""
    from fractions import Fraction

    if scene.pos_str is not None:
        return (Fraction(scene.pos_str[0]), Fraction(scene.pos_str[1]))
    return (Fraction(float(scene.pos[0])), Fraction(float(scene.pos[1])))


def scene_defaults(algo: str) -> Scene:
    """Mirror of ``Config::new(algo)`` (calc/src/lib.rs:39-69): per-algorithm
    iteration counts and the reference's *stored* (post-constructor-swap)
    colors — escape-time rendering swaps g/b again in coloring.py, so the
    effective escape colors are the literal ``Config::new`` arguments."""
    algo = normalize_algo(algo)
    if algo == "fern":
        return Scene(
            algo=algo,
            iterations=10_000_000,
            primary_color=RGB(4, 3, 100),        # stored by new(4, 100, 3)
            secondary_color=RGB(240, 240, 240),  # stored by new(240, 240, 240)
        )
    return Scene(
        algo=algo,
        iterations=50,
        primary_color=RGB(40, 255, 40),          # stored by new(40, 40, 255)
        secondary_color=RGB(240, 0, 170),        # stored by new(240, 170, 0)
    )


# ---------------------------------------------------------------------------
# Pytree registration: dynamic leaves vs static structure
# ---------------------------------------------------------------------------

_DYNAMIC_FIELDS = (
    "limit",
    "stable_limit",
    "pos",
    "scale",
    "exposure",
    "color_weight",
    "julia_set",
)
_STATIC_FIELDS = tuple(
    f.name for f in dataclasses.fields(Scene) if f.name not in _DYNAMIC_FIELDS
)


def _scene_flatten(s: Scene):
    children = tuple(getattr(s, n) for n in _DYNAMIC_FIELDS)
    aux = tuple(getattr(s, n) for n in _STATIC_FIELDS)
    return children, aux


def _scene_unflatten(aux, children):
    kw = dict(zip(_STATIC_FIELDS, aux))
    kw.update(zip(_DYNAMIC_FIELDS, children))
    s = object.__new__(Scene)
    for k, v in kw.items():
        object.__setattr__(s, k, v)
    return s


jax.tree_util.register_pytree_node(Scene, _scene_flatten, _scene_unflatten)
