"""Whole-solve parity of the port against the JAX package, in float64.

One input set (numpy float64 arrays, made from a seed by the caller) goes
through a JAX function (x64, under ``jax.jit``, on the CPU) and its port counterpart (float64
tensors on the CPU). The values are compared, and where ``argnums`` names
inputs, so are the gradients of ``<cotangent, output>`` in them, for one
cotangent drawn from a seed: a vector-Jacobian product that weighs every
output entry differently, so that an error in one batch entry or pixel
cannot hide in a sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch


def close(got, expected, rtol):
    """``|got - expected| <= rtol (|expected| + max |expected|)``, entrywise."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    expected = np.asarray(expected)
    assert got.shape == expected.shape, (got.shape, expected.shape)
    np.testing.assert_allclose(got, expected, rtol=rtol, atol=rtol * np.abs(expected).max())


def assert_solve_parity(jax_fn, torch_fn, inputs, *, rtol, grad_rtol=None, argnums=(), seed=0, jit=True):
    """Run ``inputs`` through both functions and compare.

    Args:
        jax_fn, torch_fn: the same function of the inputs in each package;
            the output is an array or a tuple of arrays (values only, then).
        inputs: numpy arrays, converted to float64 JAX arrays and tensors.
        rtol: value tolerance (see :func:`close`).
        grad_rtol: gradient tolerance; defaults to ``rtol``.
        argnums: indices of the inputs to differentiate in.
        seed: seed of the cotangent.
        jit: run the JAX function under ``jax.jit`` (False for one that
            reads concrete values of its inputs).

    Returns:
        The port's output, detached.
    """
    jin = [jnp.asarray(v) for v in inputs]
    wrap = jax.jit if jit else (lambda f: f)
    leaves = [torch.tensor(v, requires_grad=i in argnums) for i, v in enumerate(inputs)]
    if not argnums:
        jout = wrap(jax_fn)(*jin)
        with torch.no_grad():
            tout = torch_fn(*leaves)
        tl, jl = (o if isinstance(o, tuple) else (o,) for o in (tout, jout))
        assert len(tl) == len(jl)
        for t, j in zip(tl, jl):
            close(t, j, rtol)
        return tout

    def j_of(*diff):
        args = list(jin)
        for i, v in zip(argnums, diff):
            args[i] = v
        return jax_fn(*args)

    jout, vjp = jax.vjp(wrap(j_of), *(jin[i] for i in argnums))
    cot = np.random.RandomState(seed).uniform(0.5, 1.5, np.shape(jout))
    jgrads = vjp(jnp.asarray(cot))
    tout = torch_fn(*leaves)
    # An input the output does not depend on has a zero gradient, as in JAX:
    tgrads = torch.autograd.grad(
        tout, [leaves[i] for i in argnums], grad_outputs=torch.tensor(cot), materialize_grads=True
    )
    close(tout, jout, rtol)
    for t, j in zip(tgrads, jgrads):
        close(t, j, rtol if grad_rtol is None else grad_rtol)
    return tout.detach()
