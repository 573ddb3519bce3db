"""Expert-config auto-formulas match the reference's documented defaults
(Appendix A of SURVEY.md; reference process_args.c / interface.c)."""

import pytest

from starneig_jax.config import SchurConf, HessenbergConf, ReorderConf
from starneig_jax.ops.schur import schur_geometry


def test_schur_defaults_n4000():
    c = SchurConf().resolve(4000)
    # reference transcript: tile 128-ish region -> our formula: 0.02n = 80
    assert c.tile_size == 80
    assert c.aed_window_size == 320          # max(min/0.7, 0.08n)
    assert c.aed_shift_count == 240          # max(staircase, 0.06n)
    assert c.iteration_limit == 300
    assert c.window_size == 2 * c.tile_size
    assert c.update_width == 6 * c.tile_size


def test_hessenberg_defaults_n4000():
    c = HessenbergConf().resolve(4000)
    assert c.panel_width == 288              # fitted model, interface.c:73-76
    assert c.tile_size >= 256


def test_reorder_defaults():
    c = ReorderConf().resolve(4000, select_ratio=0.35)
    assert c.window_size == 2 * c.tile_size
    assert c.small_window_size == 32


# (WA, NS, B, WC, TMAX) from the reference's formulas alone:
# WA = aed_window_size + 2 with aed_window_size = max(staircase/0.7, 0.08n),
# NS = aed_shift_count = max(staircase, 0.06n), B = shifts_per_window / 2
# with shifts_per_window = (2 tile / 3 - 2) rounded to pairs and
# tile = 0.02n, WC = 6B + 4, TMAX = ceil((NS / 2) / B)
@pytest.mark.parametrize("n, want", [
    (500, (82, 56, 9, 58, 4)),
    (4000, (322, 240, 25, 154, 5)),
    (10000, (802, 600, 65, 394, 5)),
    (20000, (1602, 1200, 132, 796, 5)),
])
def test_schur_geometry(n, want):
    """The fused driver's geometry is a pure function of n and the resolved
    expert values — the same on every backend."""
    g = schur_geometry(n, SchurConf().resolve(n))
    assert (g.WA, g.NS, g.B, g.WC, g.TMAX) == want
    # the padding holds the AED window, the chase window and the parking
    # zone of masked trains
    assert g.P >= max(g.WA, g.WC + 2) + 2 + g.WC
