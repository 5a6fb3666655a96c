"""Carry state from the JAX package into the port.

Both functions take plain numpy arrays, so nothing here imports JAX:
the caller converts the JAX arrays with ``np.asarray`` first.
"""

import numpy as np
import torch

__all__ = ["adam_state_from_optax", "gmm_from_arrays", "params_from_jax",
           "params_to_numpy"]


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


def adam_state_from_optax(opt_state, params, **adam_kwargs):
    """``torch.optim.Adam`` state dict of an optax Adam state.

    Parameters
    ----------
    opt_state :
        optax's ``ScaleByAdamState`` (the first state of ``optax.adam``'s
        chain) with numpy leaves: ``count``, and ``mu`` and ``nu`` nested
        like the JAX deconvolver's params,
        ``{"components": {name: {"flux": ...}}}``.
    params : dict
        The port's nested params (``FluxComponents.parameters()``): the
        state's entries follow its leaves in insertion order, the order
        the deconvolver hands them to the optimiser.
    adam_kwargs :
        Hyper-parameters stored in the state dict's ``param_groups``
        (``lr``, ``betas``, ``eps``); the deconvolver's resume keeps its
        own and reads only ``"state"``.

    Returns
    -------
    dict
        ``state_dict()`` layout: per leaf ``step`` (the count, float32),
        ``exp_avg`` (mu) and ``exp_avg_sq`` (nu) as CPU tensors.
    """
    count = opt_state.count
    mu, nu = opt_state.mu["components"], opt_state.nu["components"]

    def paired(tree, moments1, moments2):
        for name, value in tree.items():
            if isinstance(value, dict):
                yield from paired(value, moments1[name], moments2[name])
            else:
                yield value, moments1[name], moments2[name]

    leaves = list(paired(params, mu, nu))
    placeholders = [torch.zeros(tuple(np.shape(p))) for p, _, _ in leaves]
    state = torch.optim.Adam(placeholders, **adam_kwargs).state_dict()
    state["state"] = {
        index: {
            "step": torch.tensor(float(np.asarray(count)),
                                 dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.array(m, np.float32)),
            "exp_avg_sq": torch.as_tensor(np.array(v, np.float32)),
        }
        for index, (_, m, v) in enumerate(leaves)
    }
    return state
