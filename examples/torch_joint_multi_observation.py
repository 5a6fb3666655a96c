"""Joint multi-observation deconvolution with calibrations, sharded over
several GPUs: the port (``jolideco_torch``) of
``examples/joint_multi_observation.py``.

One process per card, each running this same program on the same data:

    torchrun --nproc-per-node N examples/torch_joint_multi_observation.py

Each rank keeps a block of the observations (``make_obs_mesh()``); the
parameters are replicated and every step sums the ranks' gradients, so
that all ranks end with the same result. Run without ``torchrun`` it
trains on the one card (or with ``--device cpu`` on the CPU) without a
mesh.
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

from jolideco_torch import (  # noqa: E402
    FluxComponents,
    GMMPatchPrior,
    MAPDeconvolver,
    NPredCalibration,
    NPredCalibrations,
    SpatialFluxComponent,
)
from jolideco_torch.data import gauss_and_point_sources_gauss_psf  # noqa: E402
from jolideco_torch.parallel import make_obs_mesh  # noqa: E402


def start_mesh(device):
    """The obs mesh of a ``torchrun`` launch (NCCL, one card a rank), or
    ``None`` for a plain run."""
    if "RANK" not in os.environ:
        return None, device
    import torch
    import torch.distributed as dist
    from jolideco_torch.utils.cuda_build import LIBRARIES, load_libraries

    if device == "cpu":
        dist.init_process_group("gloo")
    else:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        device = f"cuda:{os.environ['LOCAL_RANK']}"
        # rank 0 builds the kernels, the others load its build
        if int(os.environ["RANK"]) == 0:
            load_libraries(*LIBRARIES)
        dist.init_process_group("nccl")
        dist.barrier()
    return make_obs_mesh(), device


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu', or the card (default)")
    parser.add_argument("--n-epochs", type=int, default=250)
    args = parser.parse_args()
    mesh, device = start_mesh(args.device)

    random_state = np.random.RandomState(642020)
    n_obs = 8
    datasets = {
        f"obs-{idx}": gauss_and_point_sources_gauss_psf(
            random_state=random_state
        )
        for idx in range(n_obs)
    }

    components = FluxComponents()
    components["flux"] = SpatialFluxComponent.from_flux_init_datasets(
        list(datasets.values()), upsampling_factor=2, prior=GMMPatchPrior()
    )

    calibrations = NPredCalibrations()
    for name in datasets:
        calibrations[name] = NPredCalibration()

    # one joint Adam step per epoch over all observations, each rank's
    # block of them on its card
    deco = MAPDeconvolver(
        n_epochs=args.n_epochs,
        learning_rate=0.1,
        update_strategy="joint",
        mesh=mesh,
        device=device,
    )
    result = deco.run(
        datasets=datasets, components=components, calibrations=calibrations
    )

    if mesh is None or int(os.environ["RANK"]) == 0:
        print("mesh:", deco.to_dict()["mesh"])
        print("final losses:", dict(result.trace_loss[-1]))
        for name, calibration in result.calibrations.items():
            print(name, calibration.to_dict())


if __name__ == "__main__":
    main()
