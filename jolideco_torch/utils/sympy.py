"""Symbolic doc helper (a copy of the JAX package's ``utils/sympy.py``):
expand the log of a symbolic product into an explicit sum, so that the
closed-form log-priors documented on ``InverseGammaPrior`` and
``ExponentialPrior`` can be derived again.
"""

__all__ = ["concrete_expand_log"]


def concrete_expand_log(expr):
    """Rewrite every ``log(Product(f, limits))`` as ``Sum(log(f), limits)``.

    ``sympy.expand_log`` splits logs of explicit products/powers but
    leaves symbolic ``Product`` nodes alone; this pushes the log
    through those too, using sympy's own ``replace`` traversal.

    Parameters
    ----------
    expr : sympy expression

    Returns
    -------
    sympy expression with no ``log(Product(...))`` subexpressions.
    """
    import sympy as sp

    expanded = sp.expand_log(expr, force=True)
    return expanded.replace(
        lambda node: node.func is sp.log
        and node.args[0].func is sp.concrete.products.Product,
        lambda node: sp.Sum(
            sp.log(node.args[0].function), *node.args[0].limits
        ),
    )
