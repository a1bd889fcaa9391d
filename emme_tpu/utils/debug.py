"""Debug-mode checks: the framework's analogue of the reference's
``EMME_DEBUG`` build flag (bounds/dimension/div-by-zero checks,
``Matrix.h:38-42``, ``solver.h:418-425``, plus ASan in Debug builds,
``CMakeLists.txt:7``).

On the device the container bounds checks are structural non-issues (shapes are
static and XLA-verified at trace time), so the useful debug surface is:

  * ``jax_debug_nans``: every jitted computation re-runs eagerly when an
    output contains NaN/Inf and raises at the producing primitive -- the
    runtime twin of the reference's div-by-zero guards.
  * ``validate_problem``: the input-dimension consistency checks the
    reference performs at solver construction (solver.h:418-425): grid /
    operator / marker sizes, positivity of the physical scales the kernels
    divide by.

Enable via ``driver.run(debug=True)``, input key ``"debug": true``, or the
CLI ``--debug`` flag (runtime-selectable rather than a compile-time flag).
"""

from __future__ import annotations

import jax


def enable_nan_checks() -> None:
    jax.config.update("jax_debug_nans", True)


def disable_nan_checks() -> None:
    jax.config.update("jax_debug_nans", False)


def validate_problem(p, cfg: dict) -> None:
    """Input-dimension/positivity checks (cf. solver.h:418-425: the
    reference throws on grid/coeff dimension mismatch under EMME_DEBUG).
    Raises ValueError with a named reason instead of letting a later
    kernel divide by zero or a reshape fail opaquely."""
    def positive(name, v):
        if not float(v) > 0:
            raise ValueError(f"debug: {name} must be > 0, got {v}")

    positive("npoints", p.npoints)
    positive("length", p.length)
    positive("vt", p.vt)
    positive("tau", p.tau)
    positive("R", p.R)
    if p.npoints % 2:
        raise ValueError("debug: npoints must be even (interleaved "
                         "electromagnetic ordering pairs phi/A rows)")
    if cfg.get("eigen_backend") == "sparse":
        dim = 2 * p.npoints if p.electromagnetic else p.npoints
        block = cfg.get("band_block")
        if block and dim % int(block):
            raise ValueError(
                f"debug: band_block {block} does not divide operator "
                f"dimension {dim}")
    if cfg.get("method") == "PIC":
        if int(cfg.get("marker_per_cell", 1)) <= 0:
            raise ValueError("debug: marker_per_cell must be > 0")
        if float(cfg.get("time_step", 1.0)) <= 0:
            raise ValueError("debug: time_step must be > 0")
    mesh_cfg = cfg.get("mesh") or {}
    rows = mesh_cfg.get("rows")
    if rows:
        dim = 2 * p.npoints if p.electromagnetic else p.npoints
        if dim % int(rows):
            raise ValueError(
                f"debug: mesh rows {rows} does not divide operator "
                f"dimension {dim}")
