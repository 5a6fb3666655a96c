"""Plot helpers without astropy (a copy of the JAX package's
``utils/plot.py``).

``simple_norm`` is a light replacement for
``astropy.visualization.simple_norm`` covering the stretches this package
uses (linear, sqrt, log, asinh). matplotlib is imported inside the
functions that need it.
"""

from itertools import zip_longest

import numpy as np

__all__ = ["plot_trace_loss", "plot_example_dataset", "add_cbar", "simple_norm"]


def simple_norm(data, stretch="linear", vmin=None, vmax=None, asinh_a=0.1,
                **kwargs):
    """Matplotlib normalisation with an optional nonlinear stretch."""
    from matplotlib import colors

    data = np.asarray(data)
    finite = data[np.isfinite(data)]
    if vmin is None:
        vmin = float(finite.min()) if finite.size else 0.0
    if vmax is None:
        vmax = float(finite.max()) if finite.size else 1.0

    if stretch == "linear":
        return colors.Normalize(vmin=vmin, vmax=vmax)
    if stretch == "sqrt":
        return colors.PowerNorm(gamma=0.5, vmin=vmin, vmax=vmax)
    if stretch == "log":
        return colors.LogNorm(vmin=max(vmin, 1e-12), vmax=vmax)
    if stretch == "asinh":
        a = asinh_a

        def _forward(x):
            return np.arcsinh(x / a) / np.arcsinh(1.0 / a)

        def _inverse(x):
            return a * np.sinh(x * np.arcsinh(1.0 / a))

        return colors.FuncNorm((_forward, _inverse), vmin=vmin, vmax=vmax)
    raise ValueError(f"Unknown stretch {stretch!r}")


def add_cbar(im, ax, fig):
    """Add a colorbar next to an axis."""
    bbox = ax.get_position()
    loright = bbox.corners()[-2]
    rect = [loright[0] + 0.02, loright[1], 0.02, bbox.height]
    cax = fig.add_axes(rect)
    return fig.colorbar(im, cax=cax, orientation="vertical")


def plot_trace_loss(ax, trace_loss, which=None, **kwargs):
    """Plot loss traces log-log."""
    if which is None:
        which = trace_loss.colnames

    for name in which:
        if name == "filename":
            continue
        ax.plot(trace_loss[name], label=name, **kwargs)

    ax.semilogx()
    ax.semilogy()
    ax.set_xlabel("# Iteration")
    ax.set_ylabel("Loss value")
    ax.legend()


def plot_example_dataset(data, figsize=(12, 7), **kwargs):
    """Plot the arrays of an example dataset dict."""
    import matplotlib.pyplot as plt

    data = {k: v for k, v in data.items() if k != "wcs"}

    fig, axes = plt.subplots(nrows=2, ncols=3, figsize=figsize)

    for name, ax in zip_longest(data.keys(), axes.flat):
        if name is None:
            ax.set_visible(False)
            continue
        im = ax.imshow(data[name], origin="lower", **kwargs)
        ax.set_title(name.title())
        fig.colorbar(im, ax=ax)
