"""Carry state from the JAX package into the port.

Both functions take plain numpy arrays, so nothing here imports JAX:
the caller converts the JAX arrays with ``np.asarray`` first.
"""

import numpy as np
import torch

__all__ = ["gmm_from_arrays", "params_from_jax", "params_to_numpy"]


def params_from_jax(params_np, components, device=None):
    """Load the JAX package's training ``params`` into ``components``.

    Parameters
    ----------
    params_np : dict
        ``{"components": {name: {"flux": log_flux, ...}}}`` with numpy
        leaves: the layout of ``FluxComponents.parameters()`` in
        the JAX package, wrapped as the deconvolver's params are.
    components : `FluxComponents`
        The port's components, updated in place.
    device : str or torch.device, optional
        Where the loaded tensors go (default: each component's own).

    Returns
    -------
    dict
        The same nesting with float32 tensor leaves.
    """
    def to_tensor(tree, dev):
        if isinstance(tree, dict):
            return {k: to_tensor(v, dev) for k, v in tree.items()}
        # a copy: arrays converted from JAX are read-only
        return torch.as_tensor(np.array(tree, np.float32), device=dev)

    loaded = {}
    for name, comp_params in params_np.get("components", {}).items():
        dev = device
        if dev is None:
            dev = components[name].parameters()["flux"].device
        loaded[name] = to_tensor(comp_params, dev)
        components[name].set_parameters(loaded[name])
    return {"components": loaded}


def params_to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def gmm_from_arrays(means, covariances, weights, stride):
    """The port's GMM from the arrays a JAX GMM was built from."""
    from ..priors.patches.gmm import (
        GaussianMixtureModel,
        GaussianMixtureModelMeta,
    )

    meta = GaussianMixtureModelMeta(
        stride=None if stride is None else int(stride)
    )
    return GaussianMixtureModel.from_numpy(
        np.asarray(means), np.asarray(covariances), np.asarray(weights),
        meta=meta,
    )
