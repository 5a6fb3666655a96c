"""Package-level properties of the port: no JAX, dispatch, interop."""

import ast
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import jax.numpy as jnp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.ops import gmm_fused as gf
from jolideco_torch.utils import cuda_build
from jolideco_torch.utils.interop import (
    gmm_from_arrays,
    params_from_jax,
    params_to_numpy,
)

torch.set_num_threads(1)
PACKAGE = Path(jt.__file__).parent


def test_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'optax', 'jolideco_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import jolideco_torch\n"
        "from jolideco_torch.ops import gmm_fused, gmm_pallas, pallas_fft\n"
        "from jolideco_torch.utils import interop, cuda_build\n"
        "print('ok')\n"
    )
    root = str(PACKAGE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_file_imports_jax():
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "optax", "jolideco_tpu"), path


def _docstring_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                yield body[0].value


def test_no_module_names_the_jax_package_outside_prose():
    """Only comments and docstrings may name the JAX package: no import,
    attribute, name or string (a path, say) of the code does."""
    for path in PACKAGE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        prose = {id(node) for node in _docstring_nodes(tree)}
        for node in ast.walk(tree):
            if id(node) in prose:
                continue
            words = []
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                words.append(node.value)
            elif isinstance(node, ast.Name):
                words.append(node.id)
            elif isinstance(node, ast.Attribute):
                words.append(node.attr)
            elif isinstance(node, ast.alias):
                words.append(node.name)
            elif isinstance(node, ast.ImportFrom):
                words.append(node.module or "")
            for word in words:
                assert "jolideco_tpu" not in word, (path, node.lineno)


def test_gmm_assets_are_the_jax_packages_copies():
    from jolideco_torch.priors.patches.gmm import ASSETS_DIR, GMM_REGISTRY

    assert ASSETS_DIR == PACKAGE / "assets"
    jax_assets = Path(jj.__file__).parent / "assets"
    for path in GMM_REGISTRY.values():
        assert path.parent == ASSETS_DIR
        assert (hashlib.sha256(path.read_bytes()).hexdigest()
                == hashlib.sha256((jax_assets / path.name).read_bytes())
                .hexdigest()), path.name


def test_no_card_no_default_device(monkeypatch):
    """Without a card, ``device=None`` raises instead of taking the CPU;
    ``device="cpu"`` still runs."""
    from jolideco_torch.parallel.stacked import StackedPoissonLoss

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jt.config.resolve_device(None)
    assert jt.config.resolve_device("cpu") == torch.device("cpu")

    ones = np.ones((16, 16), np.float32)
    datasets = {"obs": {"counts": ones, "psf": np.ones((3, 3)) / 9,
                        "exposure": ones, "background": ones}}
    comps = jt.FluxComponents({"flux": jt.SpatialFluxComponent.from_numpy(ones)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StackedPoissonLoss.from_datasets(datasets, comps)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        jt.MAPDeconvolver(update_strategy="joint", trace_every=0).run(
            datasets, components=comps["flux"])
    loss = StackedPoissonLoss.from_datasets(datasets, comps, device="cpu")
    assert loss.counts.device.type == "cpu"


def test_cpu_tensors_take_the_plain_version():
    gf.reset_counters()
    prior = jt.GMMPatchPrior(
        gmm=jt.GaussianMixtureModel.from_registry("builtin-8x8-v1"),
        cycle_spin=True,
    )
    flux = torch.rand((1, 1, 16, 128),
                      generator=torch.Generator().manual_seed(0)) + 0.1
    flux.requires_grad_(True)
    prior(flux).backward()
    assert gf.gmm_fused_fwd_cuda.launches == 0
    assert gf.gmm_fused_bwd_cuda.launches == 0
    assert gf.fused_forward_plain.calls == 1
    assert gf.fused_backward_plain.calls == 1
    assert torch.isfinite(flux.grad).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    gmm = jt.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    bufs = gmm.kernel_buffers("cpu")
    image = torch.ones((16, 128))
    for launch in (gf.gmm_fused_fwd_cuda, gf.gmm_fused_fwd_marg_cuda):
        with pytest.raises(ValueError):
            launch(image, bufs, 4, -1e5)
    n = gf.fused_patch_count(image.shape, 4)
    with pytest.raises(ValueError):
        gf.gmm_fused_bwd_cuda(torch.zeros((n, 64)),
                              torch.zeros(n, dtype=torch.int32),
                              torch.zeros(n), torch.zeros(n), bufs,
                              image.shape, 4)
    with pytest.raises(ValueError):
        gf.gmm_fused_bwd_marg_cuda(torch.zeros((n, 64)), torch.zeros(n),
                                   torch.zeros(n), torch.zeros(n), bufs,
                                   image.shape, 4)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build._nvcc()


def test_params_from_jax_round_trips():
    rs = np.random.RandomState(0)
    flux = rs.uniform(0.5, 2.0, (32, 32)).astype(np.float32)
    comp_j = jj.SpatialFluxComponent.from_numpy(flux)
    params_j = {"components": jj.FluxComponents(
        {"flux": comp_j}).parameters()}
    params_np = {"components": {
        name: {k: np.asarray(v) for k, v in p.items()}
        for name, p in params_j["components"].items()
    }}

    comps_t = jt.FluxComponents({
        "flux": jt.SpatialFluxComponent.from_numpy(np.ones((32, 32)))
    })
    loaded = params_from_jax(params_np, comps_t)
    back = params_to_numpy(loaded)
    assert_array_equal(back["components"]["flux"]["flux"],
                       params_np["components"]["flux"]["flux"])
    assert_array_equal(params_to_numpy(comps_t.parameters())["flux"]["flux"],
                       np.asarray(comp_j.parameters()["flux"]))
    np.testing.assert_allclose(comps_t["flux"].flux_upsampled_numpy,
                               np.asarray(comp_j.flux_upsampled)[0, 0],
                               rtol=1e-6)


def test_gmm_from_arrays_packs_like_jax():
    gmm_j = jj.GaussianMixtureModel.from_registry("builtin-8x8-v1")
    gmm_t = gmm_from_arrays(np.asarray(gmm_j.means),
                            np.asarray(gmm_j.covariances),
                            np.asarray(gmm_j.weights), gmm_j.meta.stride)
    k = gmm_t.n_components
    assert_array_equal(gmm_t.packed["aq"],
                       np.asarray(gmm_j.packed["aq"])[:, :k])
    assert_array_equal(gmm_t.packed["const2"],
                       np.asarray(jnp.asarray(gmm_j.packed["const2"]))[:, :k])


def test_precision_dial_pins_float32():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    jt.config.set_gmm_precision("default")
    try:
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
        assert jt.config.gmm_precision() == "default"
        with pytest.raises(ValueError):
            jt.config.set_gmm_precision("bf16")
    finally:
        jt.config.set_gmm_precision("high")


def test_dispatch_rule():
    assert jt.config.dispatch(torch.zeros(1)) == "plain"
    assert jt.config.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(NotImplementedError):
        jt.config.dispatch(torch.zeros(1, device="meta"))
