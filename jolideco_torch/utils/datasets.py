"""Dataset helpers (a copy of the JAX package's ``utils/datasets.py``)."""

import numpy as np

__all__ = ["split_datasets_validation"]


def split_datasets_validation(datasets, n_validation, random_state=None):
    """Split datasets into training and validation subsets.

    Parameters
    ----------
    datasets : dict of [str, dict]
        Per-dataset dicts (``counts``/``psf``/``exposure``/
        ``background``).
    n_validation : int
        Number of validation datasets.
    random_state : `numpy.random.RandomState`, optional

    Returns
    -------
    split : dict
        ``{"datasets": ..., "datasets_validation": ...}`` — matches the
        keyword names of ``MAPDeconvolver.run``.
    """
    if random_state is None:
        random_state = np.random.RandomState()

    names = list(datasets.keys())
    random_state.shuffle(names)

    names_training = names[n_validation:]
    names_validation = names[:n_validation]

    return {
        "datasets": {name: datasets[name] for name in names_training},
        "datasets_validation": {
            name: datasets[name] for name in names_validation
        },
    }
