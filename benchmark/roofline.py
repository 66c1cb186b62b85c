"""The least time of a call's pair work on the card, counted from the
call's parameters alone, whatever implements it.

Work of one loss + gradient of the debiased Sinkhorn divergence on the
online (exact) route, ``N`` and ``M`` points, one exponential a pair:

* one sweep at ``eps_list[0]`` from zero potentials, then one sweep a
  temperature of :func:`reference.schedule.epsilon_schedule`, then the
  last extrapolation: each sweep reads both directions of the ``xy`` pairs
  off one exponential a pair (``N M``), and each symmetric term off one a
  pair of its triangle, diagonal included (``N (N + 1) / 2``, ``M (M + 1)
  / 2``);
* the gradient's apply in x: the ``xy`` pairs and the ``xx`` triangle once
  more.

Bytes: each input byte read once (the clouds, float32) and each output
byte written once (the value and the gradient in x).

The least time is the larger of the bytes over the HBM rate and the
exponentials over the card's highest exponential rate: every SM's MUFU
(16 results a clock) together with its 128 FP32 lanes, each of which needs
at least :data:`EXP2_FP32_OPS` instructions for one float32-accurate
software exp2. Neither a MUFU nor an FMA-emulated exponential beats it.
"""

from .reference.schedule import epsilon_schedule

#: Published figures of the cards, by ``torch.cuda.get_device_name()``:
#: SMs, HBM bytes a second (data sheet, SXM part), MUFU results a clock an
#: SM, FP32 lanes an SM.
CARDS = {
    "NVIDIA H100 80GB HBM3": dict(sms=132, hbm_bytes_per_s=3.35e12, mufu_per_clock=16, fp32_lanes=128),
}

#: The fewest FP32-pipe instructions of a float32-accurate exp2 in software:
#: 2^x = 2^n 2^f with n = rint(x), f = x - n in [-1/2, 1/2]. The subtraction
#: is one FADD (the rounding can run on the conversion unit); 2^f needs a
#: polynomial of degree 5 (the minimax error of degree 4 is 3.6e-6 relative,
#: of degree 5 1.0e-7, under the MUFU's 2^-22.5), five FFMAs in Horner form,
#: and the exponent n goes into the bits on the integer pipe. 1 + 5 = 6.
EXP2_FP32_OPS = 6


def exp_rate(card, sm_clock_hz):
    """Exponentials a second at the card's highest rate, or ``None`` for a
    card without figures."""
    c = CARDS.get(card)
    if c is None or not sm_clock_hz:
        return None
    return c["sms"] * sm_clock_hz * (c["mufu_per_clock"] + c["fp32_lanes"] / EXP2_FP32_OPS)


def online_work(n, m, d, call):
    """``(exponentials, bytes)`` of one loss + gradient in x on the online
    route (see the module's docstring)."""
    eps_list = epsilon_schedule(call.get("p", 2), call["diameter"], call.get("blur", 0.05), call.get("scaling", 0.5))
    xy, xx, yy = n * m, n * (n + 1) // 2, m * (m + 1) // 2
    sweeps = 1 + len(eps_list) + 1
    exps = sweeps * (xy + xx + yy) + xy + xx
    nbytes = 4 * (n * d + m * d) + 4 + 4 * n * d
    return exps, nbytes


def least_seconds(exps, nbytes, card, sm_clock_hz):
    """The least time of ``exps`` exponentials and ``nbytes`` bytes on the
    card, or ``None`` for a card without figures."""
    rate = exp_rate(card, sm_clock_hz)
    if rate is None:
        return None
    return max(nbytes / CARDS[card]["hbm_bytes_per_s"], exps / rate)
