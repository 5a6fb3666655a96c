"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``; every test skips without a card. On a machine with one
(and without JAX, whose test configuration this file does not need):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: ``valid`` and the normalised patches exact to 1e-5; values
to rtol 1e-5 (float32 sums in different orders); argmax identical; the
image gradient to 1e-4 of its max-abs.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SENTINEL = -1e5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def gmm():
    from jolideco_torch.priors import GaussianMixtureModel

    return GaussianMixtureModel.from_registry("astro-snr-v1")


def make_image(shape, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)
    img[:8, :16] = 2.0 * SENTINEL
    return img


@pytest.mark.parametrize("shape,stride", [
    ((16, 128), 4), ((20, 136), 2), ((64, 256), 8), ((37, 203), 4),
    ((24, 40), 4),
])
def test_kernels_match_plain(device, gmm, shape, stride):
    from jolideco_torch.ops import gmm_fused as gf

    bufs = gmm.kernel_buffers(device)
    image = torch.as_tensor(make_image(shape), device=device)
    vk, ak, valk, xk = gf.gmm_fused_fwd_cuda(image, bufs, stride, SENTINEL)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride, SENTINEL)
    torch.cuda.synchronize()
    assert torch.equal(valk, valp)
    m = valp > 0.5
    torch.testing.assert_close(xk, xp, rtol=0, atol=1e-5)
    torch.testing.assert_close(vk[m], vp[m], rtol=1e-5, atol=0)
    assert torch.equal(ak[m], ap[m])

    dv = torch.randn(vp.shape, device=device,
                     generator=torch.Generator(device=device).manual_seed(0))
    gk = gf.gmm_fused_bwd_cuda(xp, ap, valp, dv * valp, bufs, shape, stride)
    gp = gf.fused_backward_plain(xp, ap, valp, dv * valp, bufs, shape, stride)
    torch.cuda.synchronize()
    torch.testing.assert_close(gk, gp, rtol=0,
                               atol=1e-4 * float(gp.abs().max()))


def test_prior_on_card_matches_cpu(device, gmm):
    from jolideco_torch.priors import GMMPatchPrior

    prior = GMMPatchPrior(gmm=gmm, stride=4, cycle_spin=True)
    flux = np.random.RandomState(1).uniform(0.1, 2.0, (1, 1, 96, 160))
    results = {}
    for dev in ("cpu", device):
        x = torch.as_tensor(flux.astype(np.float32), device=dev)
        x.requires_grad_(True)
        value = prior(x, shifts=(1, -2))
        value.backward()
        results[str(dev)] = (value.item(), x.grad.cpu())
    (v_cpu, g_cpu), (v_gpu, g_gpu) = results.values()
    np.testing.assert_allclose(v_gpu, v_cpu, rtol=1e-5)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0,
                               atol=1e-4 * float(g_cpu.abs().max()))
