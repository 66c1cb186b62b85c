"""The plain references, one file each, found by the name that a
configuration gives under ``"reference"`` (:meth:`benchmark.layout.Layout.reference`):
plain PyTorch, float64 by default, importing nothing of the program it
judges and taking nothing that the program made. Each exposes
``compute(inputs, call, rows, dtype=torch.float64, tf32=False)``, which
returns the value and the gradient rows ``rows`` of the configuration's
entry on ``inputs``. The other files here are their helpers."""
