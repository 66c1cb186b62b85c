"""The least time of one loss + gradient in x of the energy distance on
the card, counted from ``N``, ``M`` and ``D`` alone, whatever implements
it (read by ``kernels.energy_roofline``).

**Pairs.** Each distinct pair once, its share of the value and of the
gradient together: the ``xy`` pairs (``N M``) and the triangles of the
self terms with their diagonals (``N (N + 1) / 2``, ``M (M + 1) / 2``).

**One MUFU operation a pair**: the reciprocal square root ``r = 1 / d``
(or a square root).

**FP32-pipe instructions a pair** (FADD, FMUL, FFMA), the fewest that a
float32-accurate evaluation needs:

* the squared distance from the coordinate differences: ``D`` FADDs, then
  one FMUL and ``D - 1`` FFMAs: ``2 D``. The expanded form ``|x|^2 + |y|^2
  - 2 <x, y>`` takes fewer, but it cancels: its rounding, float32's
  6e-8 of the squared norms (0.25 on these clouds), is as large as the
  whole squared distance of a pair 1e-4 apart, so it is not
  float32-accurate;
* each gradient row that the pair serves, ``sum_j w_j r_ij (x_i - y_j)``:
  one FMUL for ``w_j r_ij`` and ``D`` FFMAs into its ``D`` sums (or, in
  the form ``x_i sum_j w_j r_ij - sum_j w_j r_ij y_j``, one FFMA and ``D``
  FFMAs on precomputed ``w_j y_j``): ``D + 1``;
* the value's sum ``sum_j w_j d_ij``: one FFMA (``w_j r_ij`` times the
  squared distance, or ``w_j`` times a MUFU square root).

An ``xy`` pair serves one gradient row (of x) and the value, ``3 D + 2``
(11 at ``D = 3``); a pair of the ``xx`` triangle serves both its rows and
the value, ``4 D + 3`` (15); a pair of the ``yy`` triangle the value
only, ``2 D + 1`` (7). The clamp ``max(sq, 1e-8)`` and the cast of
anything are not counted. The ``N + M`` diagonal pairs, which need none
of it, are about a millionth of the count at 1e6 points.

**Bytes**: each input byte read once (``a``, ``x``, ``b``, ``y`` in
float32) and each output byte written once (the value and the gradient
in x).

The least time is the largest of the MUFU operations over the MUFU rate
(16 a clock an SM), the FP32 instructions over the FP32 rate (128 lanes
a clock an SM) and the bytes over the HBM rate. At these counts the FP32
term bounds (11 / 128 > 1 / 16 a pair), and a reciprocal square root
moved off the MUFU (a Newton iteration on the FP32 pipe) only adds to
it, so no implementation beats it.
"""

from benchmark.roofline import CARDS


def energy_work(n, m, d):
    """``(pairs, fp32_ops, nbytes)`` of one loss + gradient in x of the
    energy distance between ``n`` and ``m`` points in dimension ``d``
    (see the module's docstring)."""
    xy, xx, yy = n * m, n * (n + 1) // 2, m * (m + 1) // 2
    fp32_ops = xy * (3 * d + 2) + xx * (4 * d + 3) + yy * (2 * d + 1)
    nbytes = 4 * (n + n * d + m + m * d) + 4 + 4 * n * d
    return xy + xx + yy, fp32_ops, nbytes


def least_seconds(n, m, d, card, sm_clock_hz):
    """The least time of :func:`energy_work` on ``card`` at its highest SM
    clock, or ``None`` for a card without figures."""
    c = CARDS.get(card)
    if c is None or not sm_clock_hz:
        return None
    pairs, fp32_ops, nbytes = energy_work(n, m, d)
    per_s = c["sms"] * sm_clock_hz
    return max(pairs / (c["mufu_per_clock"] * per_s), fp32_ops / (c["fp32_lanes"] * per_s),
               nbytes / c["hbm_bytes_per_s"])
