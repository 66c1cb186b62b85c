"""One run of a cell on the CPU with the chip's look skipped, optionally
with the timed path broken underneath, in a process of its own (no test
configuration that imports JAX):

    python benchmark/tests/drive.py <root> <cell> <fault>

``<root>`` holds a ``BENCHMARK.json`` and a ``benchmark/`` folder (see
``conftest.copy_benchmark``); the program comes from this checkout. One
warm-up call and 400 gradient rows, for time. Prints the result's line,
with the run's readings under ``"readings"``. The faults:

* ``none``: the program as it is;
* ``control``: the program as it is, and the control's readings too (the
  reference one precision lower in the program's place);
* ``frozen_step``: each step of the ε loop returns its state unchanged;
* ``half_batch``: half of x's points left out, the mean taken over the
  rest (the other half's weights scaled up to sum to one);
* ``altered_value``: the value altered by 1 % where the loss produces it;
* ``yy_term``: the term of y against itself, which no gradient in x sees,
  altered by 1 % where it is produced (the Sinkhorn divergence's potential
  ``g_bb``, the MMD's ``K_yy b``).
"""

import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def break_program(fault):
    import torch

    from geomloss_tpu_torch.models import kernel_samples, multiscale, samples_loss, sinkhorn_samples

    if fault in ("none", "control"):
        return
    if fault == "frozen_step":
        multiscale._iterate = lambda step, carry, eps_seg, rho, debias: carry
        real = sinkhorn_samples.sinkhorn_step_points

        def frozen(eps, x, y, a_log, b_log, f, g, **kw):
            S = real(eps, x, y, a_log, b_log, f, g, **kw)
            return (f, g) if not kw.get("sym") else (f, S[1])

        sinkhorn_samples.sinkhorn_step_points = frozen
        return
    if fault == "yy_term":
        for mod in (multiscale, sinkhorn_samples):
            cost = mod.sinkhorn_cost

            def altered(eps, rho, a, b, f_aa, g_bb, *rest, _cost=cost, **kw):
                return _cost(eps, rho, a, b, f_aa, 1.01 * g_bb, *rest, **kw)

            mod.sinkhorn_cost = altered
        # kernel_multiscale builds its tables in the order xy, xx, yy:
        built, yy_tables = [], []
        geometry, mv = kernel_samples.masks_from_geometry, kernel_samples.kernel_matvec_sparse

        def tables(*args, **kw):
            mask = geometry(*args, **kw)
            built.append(mask)
            if len(built) % 3 == 0:
                yy_tables.append(mask)
            return mask

        def altered_mv(xx, yy, vv, eps, mask, **kw):
            out = mv(xx, yy, vv, eps, mask, **kw)
            return 1.01 * out if any(mask is t for t in yy_tables) else out

        kernel_samples.masks_from_geometry = tables
        kernel_samples.kernel_matvec_sparse = altered_mv
        return
    forward = samples_loss.SamplesLoss.forward
    if fault == "half_batch":

        def half(self, a, x, b, y):
            kept = torch.zeros_like(a)
            kept[: a.shape[0] // 2] = a[: a.shape[0] // 2]
            return forward(self, kept / kept.sum(), x, b, y)

        samples_loss.SamplesLoss.forward = half
        return
    if fault == "altered_value":
        samples_loss.SamplesLoss.forward = lambda self, *args: forward(self, *args) * 1.01
        return
    raise ValueError(f"unknown fault {fault!r}")


def main(root, cell, fault):
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark import harness
    from benchmark.layout import Layout

    torch.set_num_threads(2)
    harness.WARMUP_CALLS, harness.CHECK_ROWS = 1, 400
    root = Path(root)
    lay = Layout(root, root / "benchmark")
    lay.root = CHECKOUT  # the program's sources (kernel names)
    break_program(fault)
    result, _, readings = harness.run_cell(lay, cell, 2**31 + 99, 0.05, False, torch.device("cpu"),
                                           control=fault == "control")
    print(json.dumps(dict(result, readings=readings)))


if __name__ == "__main__":
    main(*sys.argv[1:4])
