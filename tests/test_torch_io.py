"""The port's files against the JAX package's (``jolideco_torch/utils/io``,
``utils/wcs.py``, ``utils/plot.py`` and the serialisation of components,
calibrations and results).

Every object kind in every format of its registry crosses between the
packages both ways: written by the JAX package and read by the port, and
written by the port and read by the JAX package. What a file holds comes
back exactly: the configuration, the trace, the calibrations, source
positions and every linear flux. A log-flux component stores the log of
what it reads, so its flux comes back as ``exp(log(v))``, which torch and
XLA each round within one unit in the last place of ``v``. Files that the
two packages write from the same numpy content are the same bytes in FITS;
ASDF files are compared by their parsed trees (their ``asdf_library``
names the package) and YAML files by their parsed configuration and their
FITS payloads. The foreign-convention fixtures of ``tests/data/interop``
read in the port as in the JAX package. Plots hand matplotlib the same
arrays in both packages.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from numpy.testing import assert_array_equal, assert_array_max_ulp

import jolideco_torch as jt
import jolideco_tpu as jj
from jolideco_torch.utils import io as tio
from jolideco_torch.utils.io import asdf_lite as t_asdf
from jolideco_torch.utils.io import minifits as t_fits
from jolideco_torch.utils.table import Table as TTable
from jolideco_torch.utils.wcs import SimpleWCS as TWCS
from jolideco_tpu.utils.io import asdf_lite as j_asdf
from jolideco_tpu.utils.io import minifits as j_fits
from jolideco_tpu.utils.table import Table as JTable
from jolideco_tpu.utils.wcs import SimpleWCS as JWCS

torch.set_num_threads(1)

HEADER = {
    "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "CRVAL1": 83.633,
    "CRVAL2": 22.0145, "CRPIX1": 16.5, "CRPIX2": 16.5,
    "CDELT1": -0.0002777, "CDELT2": 0.0002777, "CUNIT1": "deg",
    "CUNIT2": "deg", "RADESYS": "ICRS",
}
PRIORS = {
    "uniform": lambda pkg: pkg.UniformPrior(),
    "smooth": lambda pkg: pkg.SmoothnessPrior(width=2.0),
    "gmm": lambda pkg: pkg.GMMPatchPrior(
        gmm=pkg.GaussianMixtureModel.from_registry("astro-snr-v1"),
        stride=4, cycle_spin=False),
}
PACKAGES = {"jax": jj, "torch": jt}


def flux_image(seed, shape=(16, 12)):
    return np.random.RandomState(seed).gamma(3.0, size=shape).astype(
        np.float32)


def dense(pkg, prior="gmm", log=False, seed=0, wcs=False, error=False):
    """A dense component of the same numpy content in either package."""
    flux = flux_image(seed)[np.newaxis, np.newaxis]
    kwargs = dict(flux_upsampled=flux, use_log_flux=log, upsampling_factor=2,
                  prior=PRIORS[prior](pkg), frozen=seed == 1)
    if wcs:
        kwargs["wcs"] = (JWCS if pkg is jj else TWCS)(HEADER)
    if error:
        kwargs["flux_upsampled_error"] = flux_image(seed + 7)[
            np.newaxis, np.newaxis]
    if pkg is jt:
        kwargs["device"] = "cpu"
    return pkg.SpatialFluxComponent(**kwargs)


def sparse(pkg, log=False):
    kwargs = dict(flux=np.array([4.0, 9.0, 2.5], np.float32),
                  x_pos=np.array([1.5, 2.0, 7.25], np.float32),
                  y_pos=np.array([3.0, 0.25, 9.5], np.float32),
                  shape=(16, 12), use_log_flux=log)
    if pkg is jt:
        kwargs["device"] = "cpu"
    return pkg.SparseSpatialFluxComponent(**kwargs)


def components(pkg, with_sparse=False):
    comps = pkg.FluxComponents()
    comps["disk-initial"] = dense(pkg, prior="uniform", seed=0, wcs=True)
    comps["flux"] = dense(pkg, prior="gmm", seed=1)
    if with_sparse:
        comps["points"] = sparse(pkg)
    return comps


def calibrations(pkg):
    return pkg.NPredCalibrations({
        "obs-1": pkg.NPredCalibration(shift_x=0.5, shift_y=-0.25,
                                      background_norm=1.1),
        "obs-2": pkg.NPredCalibration(background_norm=0.8, frozen=True,
                                      weight=2.0),
    })


CONFIG = {"n_epochs": 3, "beta": 1.0, "learning_rate": 0.1,
          "compute_error": False, "optimizer_kwargs": {},
          "update_strategy": "joint", "scan_chunk": None,
          "fft_shape": [48, 40], "device": "cpu", "checkpoint_path": None}


def trace(table_cls):
    table = table_cls(names=["total", "datasets-total", "filename"],
                      dtype=[float, float, str])
    for epoch in range(3):
        table.add_row({"total": 10.5 - epoch, "datasets-total": 7.25 / (
            epoch + 1), "filename": f"checkpoint-epoch-{epoch}.asdf"})
    return table


def result(pkg):
    kwargs = dict(config=dict(CONFIG), components=components(pkg),
                  trace_loss=trace(JTable if pkg is jj else TTable),
                  components_init=components(pkg),
                  calibrations=calibrations(pkg),
                  calibrations_init=calibrations(pkg))
    return pkg.MAPDeconvolverResult(**kwargs)


def plain(value):
    """A nested structure with numpy arrays and scalars as lists and
    Python scalars, tuples as lists (what both packages' dicts compare
    by)."""
    if isinstance(value, dict):
        return {key: plain(v) for key, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, np.ndarray):
        return [value.dtype.str, value.tolist()]
    if isinstance(value, np.generic):
        return value.item()
    return value


def same_component(a, b):
    """Two components (either package) hold the same configuration,
    flux, error and positions, bit for bit."""
    assert type(a).__name__ == type(b).__name__
    assert plain(a.to_dict()) == plain(b.to_dict())
    assert a.shape == b.shape
    assert_array_equal(a.flux_upsampled_numpy, b.flux_upsampled_numpy)
    if getattr(a, "flux_upsampled_error", None) is not None:
        assert_array_equal(np.squeeze(np.asarray(
            a.flux_upsampled_error_numpy)), b.flux_upsampled_error_numpy)
    if a.wcs is not None:
        assert a.wcs.to_header() == b.wcs.to_header()


def read(pkg, cls_name, path, fmt):
    cls = getattr(pkg, cls_name)
    if pkg is jt:
        return cls.read(path, format=fmt, device="cpu")
    return cls.read(path, format=fmt)


# ----------------------------------------------------------------------
# every kind, every format, both directions

KINDS = {
    "SpatialFluxComponent": (lambda pkg: dense(pkg, wcs=True, error=True),
                             tio.IO_FORMATS_FLUX_COMPONENT_WRITE),
    "SparseSpatialFluxComponent": (sparse,
                                   tio.IO_FORMATS_SPARSE_FLUX_COMPONENT_WRITE),
    "FluxComponents": (lambda pkg: components(pkg, with_sparse=True),
                       tio.IO_FORMATS_FLUX_COMPONENTS_WRITE),
    "NPredCalibrations": (calibrations,
                          tio.IO_FORMATS_NPRED_CALIBRATIONS_WRITE),
    "MAPDeconvolverResult": (result, tio.IO_FORMATS_MAP_RESULT_WRITE),
}
CASES = [(kind, fmt, writer) for kind, (_, registry) in KINDS.items()
         for fmt in registry for writer in ("jax", "torch")]


def file_config(config, fmt):
    """A configuration as a file gives it back: FITS keeps None, bools,
    ints and floats and writes anything else as its ``str`` (in both
    packages)."""
    if fmt != "fits":
        return config
    return {key: value if value is None or isinstance(
        value, (bool, int, float)) else str(value)
        for key, value in config.items()}


def same_object(kind, a, b, fmt=None):
    if kind in ("SpatialFluxComponent", "SparseSpatialFluxComponent"):
        same_component(a, b)
    elif kind == "FluxComponents":
        assert list(a) == list(b)
        for name in a:
            same_component(a[name], b[name])
    elif kind == "NPredCalibrations":
        assert list(a) == list(b) and a.to_dict() == b.to_dict()
    else:
        assert a.config == file_config(b.config, fmt)
        assert a.trace_loss.to_dict() == b.trace_loss.to_dict()
        for got, want in ((a.components, b.components),
                          (a.components_init, b.components_init)):
            same_object("FluxComponents", got, want)
        for got, want in ((a.calibrations, b.calibrations),
                          (a.calibrations_init, b.calibrations_init)):
            assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("kind,fmt,writer", CASES,
                         ids=[f"{k}-{f}-{w}" for k, f, w in CASES])
def test_files_cross_between_the_packages(kind, fmt, writer, tmp_path):
    """Written by one package, read by both: what each reads is what the
    writer held, bit for bit (linear fluxes), and the two reads agree."""
    make, _ = KINDS[kind]
    written = make(PACKAGES[writer])
    path = tmp_path / f"obj.{fmt}"
    written.write(path, format=fmt)
    got_t = read(jt, kind, path, fmt)
    got_j = read(jj, kind, path, fmt)
    same_object(kind, got_t, written, fmt)
    same_object(kind, got_t, got_j)


def test_log_flux_reads_within_one_ulp(tmp_path):
    """A log-flux component stores the log of the flux it reads: both
    packages give ``exp(log(v))`` back within one unit in the last place
    of the file's ``v`` (torch's vector and scalar loops of ``log`` may
    round the last bit apart, by the array's alignment)."""
    comp = dense(jj, prior="uniform", log=True)
    for fmt in ("fits", "asdf", "yaml"):
        path = tmp_path / f"log.{fmt}"
        comp.write(path, format=fmt)
        file_flux = np.asarray(comp.flux_upsampled_numpy)
        got_t = jt.SpatialFluxComponent.read(path, device="cpu")
        got_j = jj.SpatialFluxComponent.read(path)
        assert got_t.use_log_flux
        assert_array_max_ulp(
            got_t.parameters()["flux"].numpy()[0, 0],
            torch.log(torch.tensor(file_flux)).numpy(), 1)
        assert_array_max_ulp(got_t.flux_upsampled_numpy, file_flux, 1)
        assert_array_max_ulp(got_t.flux_upsampled_numpy,
                             np.asarray(got_j.flux_upsampled_numpy), 2)


# ----------------------------------------------------------------------
# the bytes


@pytest.mark.parametrize("kind", list(KINDS))
def test_fits_files_are_the_same_bytes(kind, tmp_path):
    make, _ = KINDS[kind]
    paths = {}
    for tag, pkg in PACKAGES.items():
        paths[tag] = tmp_path / f"{tag}.fits"
        make(pkg).write(paths[tag], format="fits")
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()


@pytest.mark.parametrize("kind", ["SpatialFluxComponent", "FluxComponents",
                                  "MAPDeconvolverResult"])
def test_asdf_trees_are_the_same(kind, tmp_path):
    make, _ = KINDS[kind]
    trees = []
    for tag, pkg in PACKAGES.items():
        path = tmp_path / f"{tag}.asdf"
        make(pkg).write(path, format="asdf")
        trees.append(plain(j_asdf.read_asdf(path)))
        assert plain(t_asdf.read_asdf(path)) == trees[-1]
        assert f"jolideco_{tag if tag == 'torch' else 'tpu'}".encode() in (
            path.read_bytes())
    assert trees[0] == trees[1]


@pytest.mark.parametrize("kind", ["SpatialFluxComponent", "FluxComponents",
                                  "NPredCalibrations"])
def test_yaml_files_are_the_same(kind, tmp_path):
    """The YAML configuration (the payload files' absolute paths aside)
    and each dense component's FITS payload."""
    import yaml

    make, _ = KINDS[kind]
    texts = {}
    for tag, pkg in PACKAGES.items():
        folder = tmp_path / tag
        folder.mkdir()
        make(pkg).write(folder / "obj.yaml", format="yaml")
        texts[tag] = (folder / "obj.yaml").read_text().replace(
            str(folder.absolute()), "<dir>")
        texts[tag + "-payloads"] = {
            p.name: p.read_bytes() for p in sorted(folder.glob("*.fits"))}
    assert yaml.safe_load(texts["jax"]) == yaml.safe_load(texts["torch"])
    assert texts["jax"] == texts["torch"]
    assert texts["jax-payloads"] == texts["torch-payloads"]


# ----------------------------------------------------------------------
# conventions the JAX package fixed


def test_conventions_kept(tmp_path):
    """The FITS writer refuses an ``InverseCDFImageNorm`` prior; a
    ``None`` config value survives FITS; a component named with "init"
    is not mangled; the config's ``device`` and ``checkpoint_path``
    cross to the JAX package and back."""
    from jolideco_torch.utils.io.fits import _config_from_hdu, _config_to_hdu

    norm = jt.InverseCDFImageNorm.from_image(flux_image(3))
    comp = jt.SpatialFluxComponent(
        flux_image(0)[np.newaxis, np.newaxis], device="cpu",
        prior=jt.GMMPatchPrior(norm=norm))
    with pytest.raises(ValueError, match="InverseCDFImageNorm"):
        comp.write(tmp_path / "cdf.fits")
    config = {"scan_chunk": None, "n_epochs": 5, "beta": 1.0,
              "update_strategy": "joint", "device": "cuda"}
    assert _config_from_hdu(_config_to_hdu(config)) == config
    res = result(jt)
    res.write(tmp_path / "r.fits")
    back = jj.MAPDeconvolverResult.read(tmp_path / "r.fits")
    assert list(back.components) == ["disk-initial", "flux"]
    assert list(back.components_init) == ["disk-initial", "flux"]
    assert back.config["device"] == "cpu"
    assert back.config["checkpoint_path"] is None


def test_reads_put_tensors_on_the_device_asked(tmp_path):
    """``read`` goes to the card by default and raises without one;
    ``device="cpu"`` puts every tensor on the CPU."""
    res = result(jt)
    res.write(tmp_path / "r.asdf")
    back = jt.MAPDeconvolverResult.read(tmp_path / "r.asdf", device="cpu")
    assert back.components["flux"].flux_upsampled.device.type == "cpu"
    assert back.calibrations["obs-1"].shift_xy.device.type == "cpu"
    if not torch.cuda.is_available():
        for call in (lambda: jt.MAPDeconvolverResult.read(tmp_path / "r.asdf"),
                     lambda: jt.FluxComponents.from_dict(
                         res.components.to_dict(include_data="numpy"))):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()


def test_str_matches_the_jax_package():
    for make in (lambda pkg: components(pkg, with_sparse=True),
                 calibrations, lambda pkg: pkg.GMMPatchPrior(
                     gmm=pkg.GaussianMixtureModel.from_registry(
                         "builtin-8x8-v1"))):
        assert str(make(jt)) == str(make(jj))
    assert str(jt.ASinhImageNorm(alpha=0.3)) == str(
        jj.utils.norms.ASinhImageNorm(alpha=0.3))
    # the deconvolver: the JAX package's lines, and the port's device
    deco = dict(n_epochs=3, update_strategy="joint")
    lines_t = str(jt.MAPDeconvolver(**deco, device="cpu")).splitlines()
    lines_j = str(jj.MAPDeconvolver(**deco)).splitlines()
    assert set(lines_j) <= set(lines_t)
    assert [line for line in lines_t if line not in lines_j] == [
        "  device                : cpu"]


# ----------------------------------------------------------------------
# the FITS subset, the interop fixtures, world coordinates

dtypes = st.sampled_from([np.float32, np.float64, np.int16, np.int32,
                          np.int64, np.uint8, np.bool_])
cards = st.dictionaries(
    st.from_regex(r"[A-Z][A-Z0-9_]{0,6}", fullmatch=True).filter(
        lambda k: k not in ("END", "SIMPLE", "BITPIX", "EXTEND", "NAXIS",
                            "PCOUNT", "GCOUNT", "EXTNAME", "XTENSION",
                            "TFIELDS", "COMMENT", "HISTORY", "CONTINUE")
        and not k.startswith(("NAXIS", "TTYPE", "TFORM"))),
    st.one_of(st.booleans(), st.integers(-2**40, 2**40),
              st.floats(allow_nan=False, allow_infinity=False, width=64),
              st.text(alphabet=st.characters(min_codepoint=32,
                                             max_codepoint=126),
                      max_size=150)),
    max_size=4)


@settings(max_examples=12, deadline=None)
@given(dtype=dtypes, shape=st.lists(st.integers(1, 5), min_size=1,
                                    max_size=3),
       header=cards, seed=st.integers(0, 2**31 - 1))
def test_minifits_round_trip_property(dtype, shape, header, seed, tmp_path_factory):
    """An image and a table of random content: the port writes the JAX
    package's bytes and both read back the values and cards."""
    rs = np.random.RandomState(seed)
    data = (rs.standard_normal(shape) * 100).astype(dtype)
    column = rs.standard_normal(shape[0])
    words = np.array([f"w{'x' * (i % 4)}'" for i in range(shape[0])])
    folder = tmp_path_factory.mktemp("fits")
    files = {}
    for tag, mod in (("jax", j_fits), ("torch", t_fits)):
        files[tag] = folder / f"{tag}.fits"
        mod.write_hdulist([
            mod.ImageHDU(data=data, header=header, name="img"),
            mod.BinTableHDU(columns={"x": column, "word": words}, name="tab")],
            files[tag])
    assert files["jax"].read_bytes() == files["torch"].read_bytes()
    for mod in (j_fits, t_fits):
        image, table = mod.read_hdulist(files["torch"])
        assert_array_equal(image.data, data)
        assert image.data.dtype == np.dtype(dtype).newbyteorder("=") or (
            dtype is np.bool_)
        for key, value in header.items():
            got = image.header[key]
            assert got == (value.rstrip() if isinstance(value, str)
                           else value)
        assert_array_equal(table.columns["x"], column)
        assert_array_equal(table.columns["word"], words)


def test_interop_fixtures_read_as_in_the_jax_package():
    from pathlib import Path

    folder = Path(__file__).parent / "data" / "interop"
    got = t_fits.read_hdulist(folder / "astropy_conventions.fits")
    want = j_fits.read_hdulist(folder / "astropy_conventions.fits")
    assert [h.name for h in got] == [h.name for h in want] == ["", "SRC"]
    assert dict(got[0].header) == dict(want[0].header)
    assert_array_equal(got[0].data, want[0].data)
    assert_array_equal(got[1].columns["flux"], want[1].columns["flux"])
    wcs = TWCS(dict(got[0].header))
    lon, lat = wcs.pixel_to_world(np.array([15.5]), np.array([15.5]))
    assert lon[0] == pytest.approx(83.633, abs=1e-6)
    assert lat[0] == pytest.approx(22.0145, abs=1e-6)

    tree_t = t_asdf.read_asdf(folder / "asdf_conventions.asdf")
    tree_j = j_asdf.read_asdf(folder / "asdf_conventions.asdf")
    assert sorted(tree_t) == ["flux", "meta"]
    assert plain(tree_t) == plain(tree_j)


def test_simple_wcs_matches_the_jax_package():
    """Both projections exactly, the CD form and the duck-typed
    ``to_header`` path."""
    rs = np.random.RandomState(4)
    x, y = rs.uniform(-300, 300, 50), rs.uniform(-300, 300, 50)
    cd = dict(HEADER)
    cd.pop("CDELT1"), cd.pop("CDELT2")
    cd.update(CD1_1=-0.04, CD1_2=0.01, CD2_1=0.02, CD2_2=0.05)
    for header in (HEADER, cd):
        wt, wj = TWCS(header), JWCS(header)
        for got, want in zip(wt.pixel_to_world(x, y),
                             wj.pixel_to_world(x, y)):
            assert_array_equal(got, want)
        lon, lat = wj.pixel_to_world(x, y)
        for got, want in zip(wt.world_to_pixel(lon, lat),
                             wj.world_to_pixel(lon, lat)):
            assert_array_equal(got, want)
        assert wt.to_header() == wj.to_header()

    class FakeAstropyWCS:
        def to_header(self):
            return dict(HEADER)

    from jolideco_torch.utils.wcs import wcs_from_header, wcs_to_header

    assert isinstance(wcs_from_header(wcs_to_header(FakeAstropyWCS())), TWCS)


def test_split_datasets_validation_matches():
    from jolideco_torch.utils.datasets import split_datasets_validation as st_
    from jolideco_tpu.utils.datasets import split_datasets_validation as sj

    datasets = {f"obs-{i}": {"counts": np.full((2, 2), i)} for i in range(7)}
    got = st_(datasets, 2, random_state=np.random.RandomState(3))
    want = sj(datasets, 2, random_state=np.random.RandomState(3))
    for key in ("datasets", "datasets_validation"):
        assert list(got[key]) == list(want[key])


def test_concrete_expand_log_matches():
    sp = pytest.importorskip("sympy")
    from jolideco_torch.utils.sympy import concrete_expand_log as ct
    from jolideco_tpu.utils.sympy import concrete_expand_log as cj

    i, n = sp.symbols("i n", integer=True, positive=True)
    x = sp.IndexedBase("x")
    expr = sp.log(sp.Product(x[i] ** 2 * sp.exp(-x[i]), (i, 1, n)))
    assert ct(expr) == cj(expr)


def test_misc_helpers_match():
    from jolideco_torch.utils import misc as tm
    from jolideco_tpu.utils import misc as jm

    data = {"a": {"b": 1, "c": {"d": 2.5}}, "e": "x"}
    for name in ("flatten_dict", "to_str"):
        assert getattr(tm, name)(data) == getattr(jm, name)(data)
    flat = tm.flatten_dict(data)
    assert tm.unflatten_dict(flat) == jm.unflatten_dict(flat) == data
    assert tm.recursive_update({"a": {"b": 0}}, {"a": {"z": 1},
                                                  "history": 2}) == (
        jm.recursive_update({"a": {"b": 0}}, {"a": {"z": 1}, "history": 2}))


# ----------------------------------------------------------------------
# plots (matplotlib under Agg)


@pytest.fixture
def plt():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as pyplot

    yield pyplot
    pyplot.close("all")


def figure_arrays(fig):
    """Every image's array and every line's data of a figure."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(im.get_array()) for im in ax.images]
        out += [np.asarray(line.get_ydata()) for line in ax.lines]
    return out


def test_plots_hand_matplotlib_the_same_arrays(plt):
    def draws(pkg):
        comps = components(pkg)
        res = result(pkg)
        norms = pkg.utils.norms
        out = []
        for draw in (lambda: comps["flux"].plot(),
                     lambda: sparse(pkg).plot(),
                     lambda: comps.plot(),
                     lambda: res.plot_trace_loss(),
                     lambda: res.peek(),
                     lambda: norms.ASinhImageNorm(alpha=0.3).plot(),
                     lambda: pkg.GaussianMixtureModel.from_registry(
                         "builtin-8x8-v1").reduce_to_topk(6)
                     .plot_mean_images(ncols=3),
                     lambda: pkg.GaussianMixtureModel.from_registry(
                         "builtin-8x8-v1").reduce_to_topk(6)
                     .plot_eigen_images(ncols=3)):
            plt.figure()
            draw()
            out.append([figure_arrays(f) for f in map(plt.figure,
                                                      plt.get_fignums())])
            plt.close("all")
        return out

    for got, want in zip(draws(jt), draws(jj)):
        assert len(got) == len(want)
        for fig_t, fig_j in zip(got, want):
            assert len(fig_t) == len(fig_j)
            for a, b in zip(fig_t, fig_j):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_plot_example_dataset(plt):
    from jolideco_torch.utils.plot import plot_example_dataset as pt
    from jolideco_tpu.utils.plot import plot_example_dataset as pj

    data = {k: flux_image(i) for i, k in enumerate(
        ("counts", "psf", "exposure", "background", "flux"))}
    shown = []
    for fn in (pt, pj):
        fn(data)
        shown.append(figure_arrays(plt.gcf()))
        plt.close("all")
    for a, b in zip(*shown):
        assert_array_equal(a, b)
