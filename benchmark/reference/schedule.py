"""GeomLoss's temperature schedule, frozen for the benchmark.

Both the reference (:mod:`sinkhorn`) and the work count of the roofline
(:mod:`benchmark.roofline`) read it, so that neither depends on how the
program under test builds its own.
"""

import math

import numpy as np


def epsilon_schedule(p, diameter, blur, scaling):
    """``[diameter^p] + exp(arange(p log diameter, p log blur, p log
    scaling)) + [blur^p]``: the geometric cooling of ε-scaling."""
    return (
        [diameter**p]
        + [float(np.exp(e)) for e in np.arange(p * math.log(diameter), p * math.log(blur), p * math.log(scaling))]
        + [blur**p]
    )
