"""Carry state from the JAX package into the port.

Both functions take plain numpy arrays, so nothing here imports JAX:
the caller converts the JAX arrays with ``np.asarray`` first.
"""

import numpy as np
import torch

__all__ = ["adam_state_from_optax", "gmm_from_arrays", "params_from_jax",
           "params_to_numpy"]


def params_from_jax(params_np, components, device=None, calibrations=None):
    """Load the JAX package's training ``params`` into ``components`` (and
    ``calibrations``).

    Parameters
    ----------
    params_np : dict
        ``{"components": {name: {"flux": log_flux, "prior": {...}}},
        "calibrations": {dataset: {"shift_xy": ...,
        "log_background_norm": ...}}}`` with numpy leaves: the JAX
        deconvolver's params (``"prior"`` where the prior trains
        parameters, an image norm's or ``MultiScalePrior``'s level
        weights, which are written into the component's prior;
        ``"calibrations"`` only when it trains some).
    components : `FluxComponents`
        The port's components, updated in place.
    device : str or torch.device, optional
        Where the loaded tensors go (default: each component's own, and
        each calibration's).
    calibrations : `NPredCalibrations`, optional
        The port's calibrations, updated in place from
        ``params_np["calibrations"]``.

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
    out = {"components": loaded}
    if "calibrations" in params_np:
        out["calibrations"] = {}
        for name, cal_params in params_np["calibrations"].items():
            dev = device
            if dev is None:
                dev = calibrations[name].shift_xy.device
            out["calibrations"][name] = to_tensor(cal_params, dev)
            calibrations[name].set_parameters(out["calibrations"][name])
    return out


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


def adam_state_from_optax(opt_state, params, calibration_params=None,
                          **adam_kwargs):
    """``torch.optim.Adam`` state dict of an optax Adam state.

    Parameters
    ----------
    opt_state :
        optax's ``ScaleByAdamState`` (the first state of ``optax.adam``'s
        chain) with numpy leaves: ``count``, and ``mu`` and ``nu`` nested
        like the JAX deconvolver's params, ``{"components": {name:
        {"flux": ..., "prior": {...}}}, "calibrations": {dataset:
        {...}}}``.
    params : dict
        The port's nested component params (``FluxComponents.parameters()``,
        the priors' trainable leaves included).
    calibration_params : dict, optional
        The port's calibration params (``NPredCalibrations.parameters()``)
        when the run trains calibrations.
    adam_kwargs :
        Hyper-parameters stored in the state dict's ``param_groups``
        (``lr``, ``betas``, ``eps``); the deconvolver's resume keeps its
        own and reads only ``"state"``.

    Returns
    -------
    dict
        ``state_dict()`` layout: per leaf, in the deconvolver's optimiser
        order (``core.optimizer_leaves``: the JAX pytree's), ``step``
        (the count, float32), ``exp_avg`` (mu) and ``exp_avg_sq`` (nu) as
        CPU tensors.
    """
    tree = {"components": params}
    if calibration_params:
        tree["calibrations"] = calibration_params

    def paired(tree, moments1, moments2):
        for name in sorted(tree):
            value = tree[name]
            if isinstance(value, dict):
                yield from paired(value, moments1[name], moments2[name])
            else:
                yield value, moments1[name], moments2[name]

    count = opt_state.count
    leaves = list(paired(tree, opt_state.mu, opt_state.nu))
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
