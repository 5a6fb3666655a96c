"""Training state on disk: parameters (the calibrations' too), optimiser
state, generator, epoch.

Counterpart of the JAX package's ``utils/checkpoint.py``, which writes
through orbax. Here the state is fetched to the host first and written
with one ``torch.save`` of CPU tensors, plain numbers and dicts, into
``<path>/train_state.pt``; it is read back with
``torch.load(weights_only=True)`` to the host. A state saved from a run
on the card therefore restores on the CPU, and the other way round. The
two packages' files are not interchangeable: an orbax checkpoint of the
JAX package does not load here, nor this file there (carry a JAX state
across with ``utils.interop`` instead).
"""

import logging
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["restore_calibration_params", "restore_train_state",
           "save_train_state"]

FILENAME = "train_state.pt"


def _map(tree, fn):
    """Apply ``fn`` to every tensor or array leaf of nested dicts/lists."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _to_host(value):
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value.copy())
    return value.detach().to("cpu", copy=True)


def save_train_state(path, params, opt_state, generator_state, epoch,
                     calibration_params=None):
    """Write the train state into the directory ``path``.

    Parameters
    ----------
    path : str or Path
        Directory, made if missing; an earlier state there is replaced.
    params : dict
        Nested dict of tensors or arrays (the components' parameters,
        their priors' trainable leaves included).
    opt_state : dict
        ``torch.optim.Optimizer.state_dict()``.
    generator_state : tensor or None
        ``torch.Generator.get_state()`` of the cycle spins' generator.
    epoch : int
        Epochs the run took.
    calibration_params : dict, optional
        The calibrations' trainable leaves, keyed by dataset name.
    """
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    state = {
        "params": _map(params, _to_host),
        "opt_state": _map(opt_state, _to_host),
        "generator_state": _map(generator_state, _to_host),
        "epoch": int(epoch),
        "calibration_params": _map(calibration_params or {}, _to_host),
    }
    torch.save(state, path / FILENAME)
    log.info(f"Saved train state to {path}")


def restore_train_state(path):
    """Read a train state written by :func:`save_train_state`.

    Returns
    -------
    (params, opt_state, generator_state, epoch)
        ``params`` with numpy leaves; ``opt_state`` a state dict with CPU
        tensors, for ``load_state_dict`` (or None); ``generator_state``
        a CPU ``uint8`` tensor, for ``torch.Generator.set_state`` (or
        None).
    """
    path = Path(path).absolute()
    state = _read(path)
    log.info(f"Restored train state from {path}")
    return (
        _map(state["params"], lambda t: t.numpy()),
        state["opt_state"],
        state["generator_state"],
        int(state["epoch"]),
    )


def restore_calibration_params(path):
    """The calibrations' leaves of a train state written by
    :func:`save_train_state`, keyed by dataset name, with numpy leaves
    (empty when it has none)."""
    state = _read(Path(path).absolute())
    return _map(state.get("calibration_params", {}), lambda t: t.numpy())


def _read(path):
    return torch.load(path / FILENAME, map_location="cpu", weights_only=True)
